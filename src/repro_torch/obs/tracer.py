"""Structured tracing over simulated clocks — the cluster's flight
recorder.

One :class:`Tracer` records the full life of every request as typed
events over the simulation's deterministic clocks: spans (``complete``),
instants, gauge counters, flow arrows tying a KV transfer's send to its
receive, and async request lifelines spanning submit → finish/cancel.
Events are stored as Chrome ``trace_event`` dicts (the format Perfetto
and ``chrome://tracing`` load directly), in **emission order** — the
emission sequence itself is the determinism artifact: same spec + seed
⇒ the same ``events`` list, so traces are CI-diffable.

Track model (how the timeline renders):

* one Chrome *process* per endpoint (``pid``), one *thread* per engine
  (``tid``) — a Cronus pair shows its PPI and CPI as two lanes under one
  endpoint group, a worker shows a single ``main`` lane;
* process 0 is the synthetic ``cluster`` process whose ``control`` lane
  carries cluster-scope instants (submit, route decisions, balancer
  splits, autoscale actions, attach/detach) and the cumulative transfer
  counters.

Track handles are small ints from :meth:`track`; the string form
``"endpoint/engine"`` (the :class:`~repro_torch.kvcache.transfer
.TransferEngine`'s pool names) resolves through :meth:`track_for`, so
flow arrows land on the same lanes the iteration spans live on.

The hot-path contract, matching the repo's other opt-in surfaces: the
tracer is only ever reached behind ``if tracer is not None`` guards, so
with tracing off no event dict — not one — is allocated, and every
aggregate metric dict stays byte-identical to an untraced run.

Timestamps are float microseconds (``sim_seconds * 1e6``), the unit
Chrome expects; the µs↔s round-trip error is ~1e-16 relative, far
inside the 1e-6 tolerance ``tools/trace_report.py`` cross-checks
against ``aggregate()``.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple


class Tracer:
    """Event recorder for one cluster run. Obtain via
    :meth:`repro_torch.serving.api.InferenceService.start_trace`."""

    def __init__(self):
        # emission-order event list: THE determinism artifact (tests
        # compare two runs' lists for equality)
        self.events: List[dict] = []
        self._meta: List[dict] = []                 # chrome "M" events
        self._procs: Dict[str, int] = {}            # process name -> pid
        self._next_tid: Dict[int, int] = {}         # pid -> next tid
        self._by_key: Dict[Tuple[str, str], int] = {}
        self._tracks: List[Tuple[int, int]] = []    # handle -> (pid, tid)
        self._flow_seq = 0
        # process 0 / thread 0: cluster-scope control lane
        self.control = self.track("cluster", "control")

    # ------------------------------------------------------------------
    # tracks
    # ------------------------------------------------------------------
    def track(self, process: str, thread: str = "main") -> int:
        """Handle for the (process, thread) lane, creating it (and its
        Perfetto naming metadata) on first use."""
        key = (process, thread)
        handle = self._by_key.get(key)
        if handle is not None:
            return handle
        pid = self._procs.get(process)
        if pid is None:
            pid = len(self._procs)
            self._procs[process] = pid
            self._meta.append({"ph": "M", "name": "process_name",
                               "pid": pid, "tid": 0,
                               "args": {"name": process}})
        tid = self._next_tid.get(pid, 0)
        self._next_tid[pid] = tid + 1
        self._meta.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": tid,
                           "args": {"name": thread}})
        handle = len(self._tracks)
        self._tracks.append((pid, tid))
        self._by_key[key] = handle
        return handle

    def track_for(self, name: str) -> int:
        """Resolve a transfer-engine pool name (``"endpoint"`` or
        ``"endpoint/engine"``) to a track, creating it lazily — a
        migration's source may be an endpoint that was never registered
        as an engine lane (or already detached)."""
        process, sep, thread = name.partition("/")
        return self.track(process, thread if sep else "main")

    # ------------------------------------------------------------------
    # emitters (t in simulated seconds)
    # ------------------------------------------------------------------
    def complete(self, track: int, name: str, t0: float, t1: float,
                 args: Optional[dict] = None, cat: str = "span") -> None:
        """A span [t0, t1] on ``track`` (chrome ``X``)."""
        pid, tid = self._tracks[track]
        ev = {"ph": "X", "name": name, "cat": cat, "pid": pid, "tid": tid,
              "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6}
        if args is not None:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, track: int, name: str, t: float,
                args: Optional[dict] = None, cat: str = "event") -> None:
        """A point event at ``t`` (chrome ``i``, thread-scoped)."""
        pid, tid = self._tracks[track]
        ev = {"ph": "i", "name": name, "cat": cat, "pid": pid, "tid": tid,
              "ts": t * 1e6, "s": "t"}
        if args is not None:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, track: int, name: str, t: float,
                values: Dict[str, float]) -> None:
        """Gauge sample(s) at ``t`` (chrome ``C``); each key renders as
        one series under the counter ``name``."""
        pid, tid = self._tracks[track]
        self.events.append({"ph": "C", "name": name, "cat": "counter",
                            "pid": pid, "tid": tid, "ts": t * 1e6,
                            "args": values})

    def new_flow_id(self) -> int:
        """Fresh id tying one flow's start to its end."""
        self._flow_seq += 1
        return self._flow_seq

    def flow_start(self, track: int, name: str, t: float, flow_id: int,
                   args: Optional[dict] = None) -> None:
        """Tail of a flow arrow (chrome ``s``) — e.g. a KV send."""
        pid, tid = self._tracks[track]
        ev = {"ph": "s", "name": name, "cat": "flow", "id": flow_id,
              "pid": pid, "tid": tid, "ts": t * 1e6}
        if args is not None:
            ev["args"] = args
        self.events.append(ev)

    def flow_end(self, track: int, name: str, t: float, flow_id: int,
                 args: Optional[dict] = None) -> None:
        """Head of a flow arrow (chrome ``f``, binding-point enclosing)
        — e.g. the matching KV receive."""
        pid, tid = self._tracks[track]
        ev = {"ph": "f", "name": name, "cat": "flow", "id": flow_id,
              "bp": "e", "pid": pid, "tid": tid, "ts": t * 1e6}
        if args is not None:
            ev["args"] = args
        self.events.append(ev)

    def async_begin(self, track: int, name: str, t: float, ident: str,
                    args: Optional[dict] = None,
                    cat: str = "request") -> None:
        """Open an async lifeline (chrome ``b``) keyed by (cat, id) —
        one per request, submit → finish/cancel."""
        pid, tid = self._tracks[track]
        ev = {"ph": "b", "name": name, "cat": cat, "id": ident,
              "pid": pid, "tid": tid, "ts": t * 1e6}
        if args is not None:
            ev["args"] = args
        self.events.append(ev)

    def async_end(self, track: int, name: str, t: float, ident: str,
                  args: Optional[dict] = None,
                  cat: str = "request") -> None:
        """Close the matching async lifeline (chrome ``e``)."""
        pid, tid = self._tracks[track]
        ev = {"ph": "e", "name": name, "cat": cat, "id": ident,
              "pid": pid, "tid": tid, "ts": t * 1e6}
        if args is not None:
            ev["args"] = args
        self.events.append(ev)

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def to_chrome(self) -> List[dict]:
        """The trace as a Chrome ``trace_event`` list: naming metadata
        first, then every event stably sorted by timestamp (stable, so
        same-instant events keep their causal emission order — e.g. a
        CPI's TTFT overwrite stays after the PPI timestamp it
        supersedes)."""
        return self._meta + sorted(self.events, key=lambda e: e["ts"])

    def export(self, path: str) -> None:
        """Write Perfetto-loadable JSON (`ui.perfetto.dev` → Open trace
        file, or ``chrome://tracing``)."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.to_chrome(),
                       "displayTimeUnit": "ms"}, f)
