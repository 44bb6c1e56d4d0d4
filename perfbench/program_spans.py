"""The port's own host-clock spans of a run's window, and the card's idle
time split by what the host was doing.

``repro_torch.obs.host`` records spans while a ``torch.profiler`` session
is open, which in a ``--trace 1`` run is the window's last seconds. Each
span carries its name, start and end on ``time.perf_counter_ns()``, the
span it opened in, its arguments and its phases; the session maps them
onto the profiler's epoch clock. A port without the recorder, or a run
that recorded nothing, gives None to every reader here.

Idle time is split by overlap: every instant of the window in which the
card ran nothing goes to the innermost span or phase the host was in
then (a span without phases counts as its own self time), else to
nothing (the harness's loop and its sleeps).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import devtrace


def window_spans(run) -> Optional[Tuple[object, List]]:
    """The recorder's session and its closed spans that lie inside the
    window ``[run.t_open, run.t_close]``; None when there are none."""
    try:
        from repro_torch.obs import host
    except ImportError:          # a port that has no recorder
        return None
    sess = host.session()
    if sess is None:
        return None
    lo, hi = int(run.t_open * 1e9), int(run.t_close * 1e9)
    spans = [sp for sp in sess.spans if sp.t1 and lo <= sp.t0
             and sp.t1 <= hi]
    return (sess, spans) if spans else None


def cpi_decodes(run) -> List:
    """The window's ``executor.decode`` spans of the CPI."""
    found = window_spans(run)
    if found is None:
        return []
    return [sp for sp in found[1] if sp.name == "executor.decode"
            and sp.args.get("engine") == "cpi"]


def phase_ns(sp, names) -> int:
    """Nanoseconds ``sp`` spent in the phases named in ``names``."""
    return sum(b - a for name, a, b in sp.phases if name in names)


def segments(sess, spans: List) -> List[Tuple[int, int, object,
                                              Optional[str]]]:
    """``(start, end, span, phase)``: the time of ``spans`` (of the session
    ``sess``) cut wherever the innermost open span or phase changes;
    ``phase`` is None for the self time of a span without phases. Spans
    nest, as the program's calls do."""
    depth: List[int] = []
    for sp in sess.spans:           # a parent opens before its children
        depth.append(depth[sp.parent] + 1 if sp.parent >= 0 else 0)
    level = {id(sp): d for sp, d in zip(sess.spans, depth)}
    parts = []
    for sp in spans:
        for name, a, b in sp.phases or [(None, sp.t0, sp.t1)]:
            parts.append((a, b, level[id(sp)], sp, name))
    # outer before inner where two start together
    parts.sort(key=lambda p: (p[0], -p[1], p[2]))
    out, stack, t = [], [], 0
    for a, b, _, sp, name in parts:
        while stack and stack[-1][0] <= a:
            end, top, top_name = stack.pop()
            out.append((t, end, top, top_name))
            t = end
        if stack:
            out.append((t, a, stack[-1][1], stack[-1][2]))
        stack.append((b, sp, name))
        t = a
    while stack:
        end, top, top_name = stack.pop()
        out.append((t, end, top, top_name))
        t = end
    return [s for s in out if s[1] > s[0]]


class Busy:
    """The union of the device's intervals, asked how much of an interval
    it covers."""

    def __init__(self, events: List[devtrace.Event]):
        merged = devtrace.union(events)
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.cum = [0]
        for a, b in merged:
            self.cum.append(self.cum[-1] + b - a)

    def before(self, t: int) -> int:
        """Busy nanoseconds before ``t``."""
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0
        return self.cum[i] - max(0, self.ends[i - 1] - t)

    def idle(self, a: int, b: int) -> int:
        """Nanoseconds of ``[a, b)`` in which the device ran nothing."""
        return (b - a) - (self.before(b) - self.before(a))


def idle_split(run) -> Optional[Dict[str, float]]:
    """Idle seconds of the window's program spans: ``launch`` (the host in
    a ``launch`` phase) and ``host_work`` (in any other phase, or in the
    self time of a span without phases). None without a device trace or
    without spans."""
    if run.trace is None:
        return None
    found = window_spans(run)
    if found is None:
        return None
    sess, spans = found
    busy = Busy(run.trace["events"])
    out = {"launch": 0, "host_work": 0}
    for a, b, _, name in segments(sess, spans):
        idle = busy.idle(sess.to_epoch_ns(a), sess.to_epoch_ns(b))
        out["launch" if name == "launch" else "host_work"] += idle
    return {k: v * 1e-9 for k, v in out.items()}
