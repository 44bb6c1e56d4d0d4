"""Reading the device trace of a run's profiled seconds.

``torch.profiler`` with CUDA activity records every kernel, copy and
memset the card ran. From those intervals this module takes the busy
time (their union), the operations that took most time, and the idle
time by what the host was doing meanwhile (the harness's own spans
around the service's steps and the executor's calls).
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Tuple

Event = Tuple[str, int, int]            # name, start ns, end ns (epoch)

PREFILL_KERNEL = re.compile(r"chunked_prefill_kernel|cronus::.*tc::kernel<")
DECODE_KERNELS = re.compile(r"\bsplit_kernel<|\bmerge_kernel<")


def profiler():
    """A profiler of CUDA activity (of the host's, without a card, which
    records nothing on a device) whose host clock reference is taken when
    it starts (``.epoch_ns`` and ``.perf_ns``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activity = (ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU)

    class _Profile(profile):
        def __enter__(self):
            out = super().__enter__()
            self.epoch_ns = time.time_ns()
            self.perf_ns = time.perf_counter_ns()
            self.perf_end_ns = None
            return out

        def __exit__(self, *exc):
            self.perf_end_ns = time.perf_counter_ns()
            return super().__exit__(*exc)

    return _Profile(activities=[activity])


def device_events(prof) -> List[Event]:
    """Every device-side interval of the profile."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name != "CUDA":
            continue
        start = ev.start_ns()
        out.append((ev.name(), start, start + ev.duration_ns()))
    return out


def union(events: List[Event]) -> List[Tuple[int, int]]:
    """The merged busy intervals of ``events``."""
    merged: List[List[int]] = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def short(name: str) -> str:
    """A kernel's name without its argument list."""
    name = name.replace("(anonymous namespace)", "{anon}").split("(")[0]
    return name[:120]


def read(prof, spans: List[Tuple[float, float, str]]) -> Optional[Dict]:
    """Busy and window seconds of the profiled interval, the ten device
    operations with most time, the idle seconds by the host span each gap
    fell in, and the events (for the kernels' readers). None when the
    profile holds no device activity."""
    events = device_events(prof)
    if not events:
        return None
    window_s = (prof.perf_end_ns - prof.perf_ns) * 1e-9
    t0 = prof.epoch_ns
    t1 = t0 + (prof.perf_end_ns - prof.perf_ns)
    busy = union(events)
    busy_s = sum(min(b, t1) - max(a, t0) for a, b in busy
                 if b > t0 and a < t1) * 1e-9
    by_name: Dict[str, float] = {}
    for name, a, b in events:
        key = short(name)
        by_name[key] = by_name.get(key, 0.0) + (b - a) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # host spans on the profile's epoch clock
    host = [(t0 + (int(a * 1e9) - prof.perf_ns),
             t0 + (int(b * 1e9) - prof.perf_ns), label)
            for a, b, label in spans]
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    idle: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        inside = [lab for s, e, lab in host if s <= mid <= e]
        calls = [lab for lab in inside if lab.startswith("executor")]
        label = (f"host in {calls[0]}" if calls else
                 "host in engine and scheduler, outside the executor"
                 if inside else "host in the harness, between steps")
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": window_s, "device_ops": ops,
            "idle_gaps": gaps, "events": events}


def kernel_seconds(events: List[Event], pattern) -> Tuple[float, int]:
    """Device seconds and count of the events whose name matches."""
    hits = [(a, b) for name, a, b in events if pattern.search(name)]
    return sum(b - a for a, b in hits) * 1e-9, len(hits)
