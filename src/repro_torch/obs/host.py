"""Host-clock spans of the port, recorded while a ``torch.profiler``
session is open: where the serving loop's host time goes, on a clock the
device trace can be laid against.

:class:`~repro_torch.obs.Tracer` records decisions on the engines'
simulated clocks; this module records what the host did, and for how
long, on the host's own clock. It adds no knob: it records exactly while
a profiler session is open in the process, so whoever profiles the server
gets the program's spans for the same seconds as the device's kernels.

How to get them::

    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import host

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            service.step()
    sess = host.session()          # this session's spans, in opening order
    for sp in sess.spans:
        print(sp.name, sp.args, sp.t1 - sp.t0, sp.phases)

How to lay them on the profiler's clock: a span's times are
``time.perf_counter_ns()``; the profiler's events (``prof.profiler.
kineto_results.events()``, their ``start_ns()``) are on the epoch clock
of ``time.time_ns()``. The session took one pair of readings of both
clocks together, so ``sess.to_epoch_ns(sp.t0)`` is ``sp.t0`` on the
profiler's clock.

A span records its name, its start and end, the span open around it when
it opened (``parent``, the index of that span in ``sess.spans``; -1 for
none), its phases, and its arguments (``args``, a dict; the spans of one
request carry its ``req_id`` as ``req``, or ``reqs`` for a batch). Phases
split a span's time at the marks its code sets: each runs from its mark
to the next mark or to the span's end.

The spans the port records, with their phases:

- ``runtime.tick`` (``ClusterRuntime.tick``), ``pair.submit``
  (``CronusPairEndpoint.submit``: ``req``, ``l_p``) and ``engine.step``
  (``Engine.step``: ``engine``, ``decode`` lanes, ``prefill_tokens``):
  no phases, their time outside their children is their own;
- ``executor.decode`` (``PagedRealExecutor.decode``: ``engine``,
  ``lanes``, ``reqs``, ``graph``: ``"replay"``, ``"capture"`` or
  ``"eager"``): ``prep``, ``launch`` (a capture falls in it),
  ``readback``, ``pick``;
- ``executor.prefill_chunk`` (``engine``, ``req``, ``tokens``,
  ``context``): ``prep``, ``launch``, then ``readback`` and ``pick`` when
  the chunk completes the prompt;
- ``executor.extract_kv`` and ``executor.inject_kv`` (``engine``,
  ``req``, ``tokens``): ``prep``, ``launch``.

``launch`` runs from the first input sent to the card through the last
operation enqueued; ``readback`` is the copy of the logits to the host,
which waits for the card; ``pick`` the greedy choice on the host.

Sessions. The profiler is one per process, so the recorder is too: the
spans go to the module's current session. A session is told from the one
before by a span site that found no profiler open in between (any
serving step does); the first span opened under a profiler after that
starts a fresh session, and the one before stays readable through
:func:`session` until then. Two profiler sessions with no span site run
between them share one session here.

Cost. With no profiler open, :func:`span` reads one attribute (the
profiler module's ``_is_profiler_enabled``, found through
``sys.modules``: a process that never imported torch pays a dict lookup,
and this module imports no torch) and returns :data:`OFF`, whose enter,
exit and ``phase`` do nothing; a site records and keeps nothing. On the
host of an H100 machine a site costs about 0.2 us, and a span about 2 us
while recording. The profiler's CUDA tracing itself slows every kernel
launch there (from about 6 to about 11 us), so spans recorded under it
time a slower loop than the untraced one (``PERF.md``, section 5).
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Tuple

_PROFILER = "torch.autograd.profiler"


class Span:
    """One recorded span; a context manager (entering opens it under the
    innermost open span of its session, leaving closes it)."""

    __slots__ = ("name", "parent", "t0", "t1", "marks", "args", "_sess",
                 "_first")

    def __init__(self, sess: "Session", name: str, phase: Optional[str]):
        self.name = name
        self.parent = -1
        self.t0 = self.t1 = 0
        self.marks: List[Tuple[str, int]] = []
        self.args: Dict = {}
        self._sess = sess
        self._first = phase

    def __enter__(self) -> "Span":
        sess = self._sess
        self.parent = sess._open[-1] if sess._open else -1
        sess._open.append(len(sess.spans))
        sess.spans.append(self)
        self.t0 = time.perf_counter_ns()
        if self._first is not None:
            self.marks.append((self._first, self.t0))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1 = time.perf_counter_ns()
        self._sess._open.pop()
        return False

    def phase(self, name: str) -> None:
        """End the current phase, if any, and start ``name`` now."""
        self.marks.append((name, time.perf_counter_ns()))

    @property
    def phases(self) -> List[Tuple[str, int, int]]:
        """``(name, start, end)`` of each phase, in order."""
        ends = [t for _, t in self.marks[1:]] + [self.t1]
        return [(name, t, end) for (name, t), end in zip(self.marks, ends)]


class _Off:
    """What :func:`span` returns with no profiler open: false, and a
    context manager and ``phase`` that do nothing."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def phase(self, name: str) -> None:
        pass


OFF = _Off()


class Session:
    """The spans of one profiler session, in the order they opened, and
    the pair of clock readings that maps them onto the profiler's."""

    def __init__(self):
        # the tightest of three brackets of the epoch reading, so that a
        # preemption between two reads does not shift the mapping
        best = None
        for _ in range(3):
            p0 = time.perf_counter_ns()
            epoch = time.time_ns()
            p1 = time.perf_counter_ns()
            if best is None or p1 - p0 < best[0]:
                best = (p1 - p0, epoch, (p0 + p1) // 2)
        _, self.epoch_ns, self.perf_ns = best
        self.spans: List[Span] = []
        self._open: List[int] = []      # indices of the spans open now

    def to_epoch_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` time on the epoch clock of
        ``time.time_ns()``, the profiler's."""
        return self.epoch_ns + (perf_ns - self.perf_ns)


_profiler = None          # torch.autograd.profiler, once imported
_current: Optional[Session] = None
# set when a span site finds no profiler open: the next span recorded
# starts a fresh session
_seen_off = True


def span(name: str, phase: Optional[str] = None):
    """The span ``name`` (its first phase ``phase``, from its start), to
    enter around the work; :data:`OFF` when no profiler session is open.
    Sites set ``args`` behind ``if sp:``, so nothing is built when off."""
    global _profiler, _current, _seen_off
    prof = _profiler
    if prof is None:
        prof = _profiler = sys.modules.get(_PROFILER)
        if prof is None:
            return OFF
    if not prof._is_profiler_enabled:
        _seen_off = True
        return OFF
    if _seen_off:
        _current = Session()
        _seen_off = False
    return Span(_current, name, phase)


def session() -> Optional[Session]:
    """The newest session: the open one, else the last; None before the
    first span recorded in this process."""
    return _current
