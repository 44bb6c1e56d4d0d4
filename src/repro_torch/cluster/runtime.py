"""Event-driven cluster runtime (xoscar-style actor loop, single process).

Before this module, each system class (Cronus, DP, PP) carried a private
copy of the same discrete-event loop: dispatch arrivals, move KV handoffs,
advance the lagging engine, jump clocks when idle. ``ClusterRuntime``
is that loop, written once, over an arbitrary set of *endpoints*:

  * an :class:`Endpoint` is a routable unit that accepts requests — a
    standalone chunked-prefill worker (:class:`WorkerEndpoint`) or a Cronus
    PPI+CPI pair (``repro_torch.cluster.pair.CronusPairEndpoint``);
  * engines register with the runtime through their endpoint's ``engines``
    tuple and are advanced lagging-first (the engine with the smallest
    local clock that can make progress steps next — the same rule the
    per-system loops used, now global across the whole cluster);
  * timed events (KV-transfer completions posted by endpoints via
    :meth:`ClusterRuntime.post`) are kept in a heap and delivered eagerly
    in (time, seq) order — eager because engine admission gates on each
    request's ``ready_time``, so delivery order is deterministic and
    execution can never start before the event's timestamp.

Request timing is enforced by the engines themselves (``arrival`` /
``ready_time`` gate admission), so delivering a routed request into an
engine's queue "early" never lets it run early — which is what makes this
single loop bit-compatible with the three loops it replaced.
"""
from __future__ import annotations

import abc
import dataclasses
import heapq
import itertools
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine import Engine
from repro_torch.core.metrics import aggregate
from repro_torch.core.request import ReqState, Request
from repro_torch.kvcache.transfer import TransferEngine
from repro_torch.obs import host


@dataclasses.dataclass(frozen=True)
class EndpointStats:
    """Load snapshot the routers and the autoscaler read.

    ``busy_frac`` is the max over the endpoint's engines of the fraction
    of the trailing ``Engine.BUSY_WINDOW`` simulated seconds spent
    executing iterations (max, not mean: a pair whose CPI is saturated is
    busy no matter how idle its PPI runs — scale-down must wait for both).
    ``oldest_queued_age`` is how long the oldest still-queued request has
    waited since its arrival — the leading signal that the endpoint mix
    is underprovisioned, visible long before goodput degrades."""
    queue_depth: int        # queued + resident, not yet finished
    free_kv_blocks: int     # free blocks on the endpoint's decode engine
    clock: float            # max engine clock (how far this endpoint has run)
    busy_frac: float = 0.0          # utilization over the trailing window
    oldest_queued_age: float = 0.0  # seconds the oldest queued request waited


class Endpoint(abc.ABC):
    """A routable unit of the cluster: one or more engines + local policy."""

    name: str

    @property
    @abc.abstractmethod
    def engines(self) -> Tuple[Engine, ...]:
        """Engines this endpoint registers with the runtime (order = tie
        order for lagging-first advancement)."""

    @abc.abstractmethod
    def can_accept(self, req: Request) -> bool:
        """May the router hand this request over right now?"""

    @abc.abstractmethod
    def submit(self, req: Request, runtime: Optional["ClusterRuntime"] = None):
        """Take ownership of a routed request."""

    def pump(self, runtime: Optional["ClusterRuntime"] = None):
        """Move internal handoffs (e.g. PPI->CPI KV transfers). Default: none."""

    def cancel(self, req: Request) -> bool:
        """Abort a routed request mid-flight: free its slot/KV blocks and
        record the cancelled terminal state. True if an engine held it."""
        for e in self.engines:
            if e.cancel(req.req_id) is not None:
                return True
        return False

    @abc.abstractmethod
    def finished(self) -> List[Request]:
        """Requests that completed on this endpoint."""

    def n_finished(self) -> int:
        """Completion count — hot path; override to avoid list copies."""
        return len(self.finished())

    def cached_prefix_tokens(self, req: Request) -> int:
        """Longest prefix of ``req``'s prompt resident in any of this
        endpoint's KV caches (0 when prefix caching is off) — the
        prefix-affinity routing signal. Read-only probe."""
        return max(e.allocator.lookup_prefix(req.prompt)
                   for e in self.engines)

    @property
    def sched_policy(self) -> str:
        """Batch-composition policy of the decode-side engine (pairs put
        the decode engine last in ``engines``) — where dynamic-KV growth
        and preemption happen, so it's the policy routers/operators care
        about when endpoints differ."""
        return self.engines[-1].ecfg.sched_policy

    def stats(self) -> EndpointStats:
        """Live load/capacity snapshot the routers and autoscaler read."""
        engines = self.engines
        queued = sum(len(e.queue) for e in engines) + sum(
            1 for e in engines for r in e.slots if r is not None)
        decode = engines[-1]   # pairs put the decode engine last
        clock = max(e.clock for e in engines)
        arrivals = [r.arrival for e in engines for r in e.queue]
        return EndpointStats(
            queue_depth=queued,
            free_kv_blocks=decode.stats().free_kv_blocks,
            clock=clock,
            busy_frac=max(e.busy_fraction() for e in engines),
            oldest_queued_age=(max(clock - min(arrivals), 0.0)
                               if arrivals else 0.0),
        )

    def drain(self) -> List[Request]:
        """Evict every resident and queued request for recompute elsewhere
        (endpoint detach). Residents leave via preemption-by-recompute —
        generated tokens folded into the prompt, KV freed — and everything
        queued is stripped of engine-local state, because any KV or
        payload it references lives on the hardware being removed. Returns
        the displaced requests (``finished()`` is untouched); afterwards
        the endpoint holds no work and allocator invariants are clean."""
        return [r for e in self.engines for r in e.drain_requests()]

    def migrate(self) -> List[Request]:
        """Evict every resident and queued request, carrying its computed
        KV *as a payload* instead of discarding it (detach with
        ``migrate=True``). Displaced requests re-enter the pending queue
        as KV-carrying migrants; the dispatcher ships each one through
        the cluster :class:`~repro_torch.kvcache.TransferEngine` to an endpoint
        that ``accepts_kv`` it, falling back to recompute when none does.
        Requests with nothing extractable (still queued, or mid-transfer
        with no local KV) degrade to the same strip ``drain`` applies."""
        return [r for e in self.engines for r in e.migrate_requests()]

    def accepts_kv(self, req: Request) -> bool:
        """May a KV-carrying migrant be shipped here right now? Default
        False: only endpoints that know how to ingest a foreign payload
        opt in."""
        return False

    def submit_kv(self, req: Request,
                  runtime: Optional["ClusterRuntime"] = None):
        """Take ownership of a migrated KV-carrying request *without*
        resetting its ``ready_time`` (the transfer engine already gated
        delivery on it)."""
        raise NotImplementedError(
            f"endpoint {self.name!r} does not ingest migrated KV")


class WorkerEndpoint(Endpoint):
    """A standalone chunked-prefill+decode instance (DP worker, or the
    single fused engine of the PP baseline).

    ``queue_cap`` bounds the *waiting queue* only (paper §5.1's DP caps);
    ``None`` means unbounded (PP: everything funnels into one engine).
    """

    def __init__(self, name: str, engine: Engine,
                 queue_cap: Optional[int] = None):
        self.name = name
        self.engine = engine
        self.queue_cap = queue_cap

    @property
    def engines(self) -> Tuple[Engine, ...]:
        """The single wrapped engine."""
        return (self.engine,)

    def can_accept(self, req: Request) -> bool:
        """Whether the engine's queue has room (``queue_cap=None``: always)."""
        if self.queue_cap is None:
            return True
        return len(self.engine.queue) < self.queue_cap

    def submit(self, req: Request, runtime=None):
        """Queue a routed request on the engine (ready at its arrival)."""
        req.ready_time = req.arrival
        self.engine.add_request(req)

    def accepts_kv(self, req: Request) -> bool:
        """Whether this worker will ingest a migrated request's KV."""
        # a chunked worker can resume any migrant: ingest places it
        # straight into decode when the payload covers the prompt, or
        # continues the partial prefill otherwise
        return self.can_accept(req)

    def submit_kv(self, req: Request, runtime=None):
        """Ingest a migrated request, KV payload and all."""
        # deliberately NOT resetting ready_time: the migration transfer
        # gated delivery on it, and the payload's KV is only valid from
        # the moment the source finished extracting it
        self.engine.add_request(req)

    def finished(self) -> List[Request]:
        """Requests this endpoint completed."""
        return list(self.engine.finished)

    def n_finished(self) -> int:
        """Count of completed requests."""
        return len(self.engine.finished)


@dataclasses.dataclass(order=True)
class _Event:
    time: float
    seq: int
    fn: Callable[[], None] = dataclasses.field(compare=False)


class ClusterRuntime:
    """The shared event loop. One instance per ``run()`` of a trace."""

    def __init__(self, endpoints: Sequence[Endpoint], router):
        self.endpoints = list(endpoints)
        self.router = router
        # flight recorder (repro_torch.obs): set by InferenceService.start_trace;
        # None = zero tracing overhead anywhere in the loop
        self.tracer = None
        self.engines: List[Engine] = [e for ep in self.endpoints
                                      for e in ep.engines]
        self._events: List[_Event] = []
        self._seq = itertools.count()
        # completions that outlive their endpoint: detach_endpoint moves
        # the departing endpoint's finished requests here so fleet metrics
        # and the n_finished termination condition never lose them
        self.retired: List[Request] = []
        self._draining: set = set()   # endpoint names closed to routing
        # per-endpoint dispatch tally (routed submits + KV deliveries),
        # surfaced by the opt-in utilization breakdown; survives detach so
        # a departed endpoint's share of the load stays attributed
        self.dispatched: Dict[str, int] = {}
        # every cross-pool KV move (PPI->CPI handoff, detach migration,
        # prefix fetch) goes through the one cluster transfer engine
        self.transfers = TransferEngine(self)
        for ep in self.endpoints:
            self.transfers.register(ep)
        if hasattr(router, "bind_runtime"):
            router.bind_runtime(self)

    # ------------------------------------------------------------------
    # timed events
    # ------------------------------------------------------------------
    def post(self, time: float, fn: Callable[[], None]):
        """Schedule ``fn`` at simulated time ``time`` (KV-transfer
        completions, deferred re-injections, ...)."""
        heapq.heappush(self._events, _Event(time, next(self._seq), fn))

    def _drain_events(self):
        # Delivery is EAGER: a routed request can't execute before its
        # ready_time anyway (engine admission gates on it), so holding an
        # event back until clocks reach its timestamp would only delay the
        # receiving queue, not change timing. The heap's job is to fire
        # simultaneous deliveries in deterministic (time, seq) order.
        while self._events:
            heapq.heappop(self._events).fn()

    # ------------------------------------------------------------------
    # live membership (elastic autoscaling)
    # ------------------------------------------------------------------
    def attach_endpoint(self, ep: Endpoint, now: Optional[float] = None):
        """Add ``ep`` to the live cluster. Its engines' clocks are pulled
        forward to ``now`` (default: the cluster's current max clock) so a
        freshly attached endpoint can never execute in the simulated past,
        and the router is told membership changed."""
        if any(e.name == ep.name for e in self.endpoints):
            raise ValueError(f"duplicate endpoint name {ep.name!r}")
        if now is None:
            now = max((e.clock for e in self.engines), default=0.0)
        for eng in ep.engines:
            eng.clock = max(eng.clock, now)
            eng.busy_since = eng.clock
        self.endpoints.append(ep)
        self.engines = [e for ep_ in self.endpoints for e in ep_.engines]
        self.transfers.register(ep)
        if self.tracer is not None:
            self.tracer.instant(self.tracer.control, "attach", now,
                                {"endpoint": ep.name}, cat="membership")
        self.router.on_membership_change(self.endpoints)

    def detach_endpoint(self, name: str,
                        pending: Optional[deque] = None,
                        migrate: bool = False) -> Endpoint:
        """Remove endpoint ``name`` from the live cluster, losing no work:
        the endpoint is first marked unroutable, its residents are drained
        — via the preemption-by-recompute path by default, or carrying
        their computed KV as migration payloads when ``migrate=True`` —
        the displaced requests are requeued into ``pending`` for
        re-routing, its finished requests are retired into fleet metrics,
        and only then are its engines removed from the event loop — with
        every allocator's ``check_invariants`` verified clean. Call
        between ticks (posted events are always drained within a tick).

        With ``migrate=True`` the dispatcher ships each KV-carrying
        migrant through :attr:`transfers` to an endpoint that
        ``accepts_kv`` it; migrants nobody accepts fall back to
        recompute, so migration is never worse than drain."""
        for ep in self.endpoints:
            if ep.name == name:
                break
        else:
            raise KeyError(f"unknown endpoint {name!r}; have "
                           f"{[e.name for e in self.endpoints]}")
        self._draining.add(name)
        if self.tracer is not None:
            self.tracer.instant(
                self.tracer.control, "detach",
                max((e.clock for e in self.engines), default=0.0),
                {"endpoint": name, "migrate": migrate}, cat="membership")
        try:
            displaced = ep.migrate() if migrate else ep.drain()
            for r in displaced:
                r.kv_src = name    # transfer-accounting source tag
            if displaced and pending is None:
                raise RuntimeError(
                    f"endpoint {name!r} holds {len(displaced)} unfinished "
                    "request(s) but no pending queue was given to requeue "
                    "them into")
            if pending is not None:
                # stable re-insertion keeps pending sorted by arrival (the
                # dispatch discipline run()'s up-front sort establishes);
                # displaced arrivals are in the past, so they re-route
                # ahead of future traffic
                for r in sorted(displaced, key=lambda r: r.arrival):
                    i = len(pending)
                    while i > 0 and pending[i - 1].arrival > r.arrival:
                        i -= 1
                    pending.insert(i, r)
            self.retired.extend(ep.finished())
            for eng in ep.engines:
                assert not eng.queue and all(s is None for s in eng.slots), \
                    f"drain left work on engine {eng.name!r}"
                eng.allocator.check_invariants()
            self.endpoints.remove(ep)
            self.engines = [e for ep_ in self.endpoints
                            for e in ep_.engines]
            self.transfers.deregister(name)
            self.router.on_membership_change(self.endpoints)
        finally:
            self._draining.discard(name)
        return ep

    # ------------------------------------------------------------------
    def n_finished(self) -> int:
        """Completions fleet-wide, including detached endpoints' retirees."""
        return sum(ep.n_finished() for ep in self.endpoints) \
            + len(self.retired)

    def _dispatch(self, pending: deque):
        """Route pending arrivals in head-of-line order (the discipline of
        the per-system loops this replaced). Routers that defer the head
        for placement reasons of their own (session stickiness) may opt
        into a bounded ``lookahead`` window so one pinned request doesn't
        convoy the unrelated traffic queued behind it. Endpoints mid-drain
        (``detach_endpoint``) are withheld from the router entirely."""
        endpoints = self.endpoints
        if self._draining:
            endpoints = [ep for ep in endpoints
                         if ep.name not in self._draining]
            if not endpoints:
                return
        while pending:
            head = pending[0]
            if head.kv_payload is not None and not head.local_payload \
                    and head.slot is None:
                # detach-time migrant carrying extracted KV: ship it
                # through the transfer engine to an endpoint that can
                # ingest the payload; nobody willing -> recompute
                pending.popleft()
                if not self._route_kv(head, endpoints):
                    _strip_to_recompute(head)
                    pending.appendleft(head)   # re-route as a fresh job
                continue
            ep = self.router.select(pending[0], endpoints)
            if ep is not None:
                self._record_dispatch(ep.name)
                if self.tracer is not None:
                    self._trace_route(head, ep)
                ep.submit(pending.popleft(), self)
                continue
            window = getattr(self.router, "lookahead", 0)
            placed_at = None
            for i, req in enumerate(pending):
                if i == 0:
                    continue
                if i > window:
                    break
                ep = self.router.select(req, endpoints)
                if ep is not None:
                    placed_at = i
                    break
            if placed_at is None:
                break   # nothing in the window can be placed right now
            req = pending[placed_at]
            del pending[placed_at]
            self._record_dispatch(ep.name)
            if self.tracer is not None:
                self._trace_route(req, ep, lookahead=placed_at)
            ep.submit(req, self)

    def _route_kv(self, req: Request, endpoints: List[Endpoint]) -> bool:
        """Ship a KV-carrying migrant to the least-loaded endpoint that
        will ingest it. The transfer engine schedules delivery at the
        migrant's ``ready_time`` (when extraction finished on the source)
        and the receiving engine charges the wire cost at ingest, exactly
        like a Cronus handoff. False when no endpoint accepts — the
        caller strips the payload and falls back to recompute routing."""
        acceptors = [ep for ep in endpoints if ep.accepts_kv(req)]
        if not acceptors:
            return False
        stats = [(ep.stats(), i, ep) for i, ep in enumerate(acceptors)]
        _, _, dst = min(stats,
                        key=lambda t: (t[0].queue_depth,
                                       -t[0].free_kv_blocks, t[1]))
        self._record_dispatch(dst.name)
        if self.tracer is not None:
            self.tracer.instant(
                self.tracer.control, "route_kv", req.ready_time,
                {"req": req.req_id, "endpoint": dst.name,
                 "src": req.kv_src or "detached",
                 "tokens": req.context_len})
        self.transfers.transfer(
            req, src=req.kv_src or "detached", dst=dst.name,
            deliver=lambda r, e=dst: e.submit_kv(r, self),
            when=req.ready_time, kind="migration")
        return True

    def _record_dispatch(self, name: str) -> None:
        self.dispatched[name] = self.dispatched.get(name, 0) + 1

    def _trace_route(self, req: Request, ep: Endpoint,
                     lookahead: int = 0) -> None:
        """Route-decision instant on the control track (tracing on only):
        which endpoint won the request, under which router, at what load
        (the router's selection signal)."""
        s = ep.stats()
        args = {"req": req.req_id, "endpoint": ep.name,
                "router": type(self.router).__name__,
                "queue_depth": s.queue_depth,
                "free_kv_blocks": s.free_kv_blocks}
        if lookahead:
            args["lookahead"] = lookahead
        self.tracer.instant(self.tracer.control, "route", req.arrival, args)

    def tick(self, pending: deque) -> bool:
        """One round of the event loop: dispatch pending arrivals, move
        internal handoffs, then advance the globally-lagging runnable
        engine (or, if the whole cluster is idle, jump every clock to the
        next event time). Returns False only when no progress is possible
        at all — the online facade (``repro_torch.serving.api``) drives this
        incrementally; ``run`` below is the batch replay over it."""
        with host.span("runtime.tick"):
            return self._tick(pending)

    def _tick(self, pending: deque) -> bool:
        self._dispatch(pending)

        # ---- internal handoffs; fire what they posted --------------
        for ep in self.endpoints:
            ep.pump(self)
        self._drain_events()

        # ---- advance the globally-lagging runnable engine ----------
        for eng in sorted(self.engines, key=lambda e: e.clock):
            if eng.runnable():
                eng.step()
                return True
        # cluster idle: jump every clock to the next event time
        # (pump deliveries drained above, so only engine ready
        # times and undispatched arrivals remain)
        nexts = [t for e in self.engines
                 if (t := e.next_ready_time()) is not None]
        if pending:
            nexts.append(pending[0].arrival)
        # a candidate no clock sits below advances nothing: a past-arrival
        # pending head that dispatch just refused (admission caps — e.g.
        # work displaced by a detach) must not pin the jump to a no-op
        nexts = [t for t in nexts if any(t > e.clock for e in self.engines)]
        if not nexts:
            return False   # nothing can advance: honest stall
        t = min(nexts)
        for e in self.engines:
            e.clock = max(e.clock, t)
        return True

    def next_time(self, pending: Optional[deque] = None) -> Optional[float]:
        """Earliest simulated time at which the cluster can make progress
        (runnable engine clock, queued ready time, posted event, or the
        head pending arrival). None when fully idle."""
        cands = [e.clock for e in self.engines if e.runnable()]
        cands += [t for e in self.engines
                  if (t := e.next_ready_time()) is not None]
        if self._events:
            cands.append(self._events[0].time)
        if pending:
            cands.append(pending[0].arrival)
        return min(cands) if cands else None

    def next_action_time(self, pending: Optional[deque] = None
                         ) -> Optional[float]:
        """Simulated time of the next *executed* action: the lagging
        runnable engine's clock (what ``tick`` will step), or — only when
        nothing is runnable — the idle-jump target ``next_time`` reports.
        The open-loop driver gates live submissions on this rather than
        ``next_time``: a queued ready-time can be earlier than every
        runnable clock, and stopping on it would let an iteration *at or
        past* the submission instant run before the request exists."""
        run = [e.clock for e in self.engines if e.runnable()]
        if run:
            return min(run)
        return self.next_time(pending)

    def run(self, requests: List[Request], max_steps: int = 10_000_000):
        """Replay a trace over the cluster; returns aggregate metrics."""
        check_requests_fresh(requests)
        pending = deque(sorted(requests, key=lambda r: r.arrival))
        total = len(requests)
        steps = 0
        while self.n_finished() < total and steps < max_steps:
            steps += 1
            if not self.tick(pending):
                break
        return aggregate([r.metrics for ep in self.endpoints
                          for r in ep.finished()]
                         + [r.metrics for r in self.retired])


def _strip_to_recompute(r: Request) -> None:
    """Turn an unplaceable KV migrant back into a recompute job: fold its
    generated tokens into the prompt (the preemption discipline — they
    are committed output, replayed as context) and drop every payload
    field, so normal routing sees a fresh-looking request."""
    if r.generated:
        r.prompt = np.concatenate(
            [r.prompt, np.asarray(r.generated, np.int32)])
        r.output_len -= len(r.generated)
        r.generated = []
        r.preempted = True
    r.kv_payload = None
    r.first_token = None
    r.local_payload = False
    r.partial_len = 0
    r.context_len = 0
    r.kv_src = None
    r.state = ReqState.WAITING
    r.ready_time = r.arrival


def check_requests_fresh(requests: Sequence[Request]) -> None:
    """Engines mutate requests in place (state, generated tokens, metrics),
    so replaying the same ``Request`` objects twice silently corrupts the
    second run. Refuse loudly instead — callers re-using a trace should
    pass fresh copies (``Trace.fresh()`` / ``copy.deepcopy``)."""
    for r in requests:
        if (r.state is not ReqState.WAITING or r.generated
                or r.slot is not None or r.context_len != 0
                or r.metrics.first_token_time is not None
                or r.metrics.finish_time is not None
                or r.metrics.cancelled):
            raise ValueError(
                f"request {r.req_id!r} was already replayed through a "
                "system (engines mutate requests in place); pass fresh "
                "copies — Trace.fresh() or copy.deepcopy the trace")
