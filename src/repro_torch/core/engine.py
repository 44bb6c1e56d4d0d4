"""Continuous-batching inference engine with chunked prefill (vLLM-class).

One ``Engine`` models one serving instance (one device or pod slice). Each
``step()`` executes a single iteration. Batch composition is no longer the
engine's business: a pluggable :class:`~repro_torch.scheduling.Scheduler` policy
(``EngineConfig.sched_policy``) turns the current slots/queue/allocator
state into an :class:`~repro_torch.scheduling.IterationPlan` — which queued
requests to admit, which residents to preempt (recompute), which requests
decode, and which prefill chunks (possibly several requests packed into the
token budget) run. The engine applies the plan: it moves requests, grows
paged-KV allocations lazily via ``BlockAllocator.extend_to`` when the
policy schedules lazily, executes compute through the pluggable executor
(real JAX or null), and charges roofline time for the composed batch.

The engine doubles as:
  * the CPI (chunked prefill instance) of Cronus — requests arrive with
    ``partial_len`` set and a KV payload to ingest,
  * a standalone DP worker (chunked prefill + decode),
  * a decode-only / prefill-only instance for the disaggregated baselines
    (via ``prefill_only`` / ``decode_only``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.core.balancer import CPIStats
from repro_torch.core.request import ReqState, Request
from repro_torch.kvcache import BlockAllocator
from repro_torch.obs import host
from repro_torch.scheduling import IterationPlan, SchedulerView, make_scheduler


@dataclasses.dataclass
class EngineConfig:
    """Static configuration of one serving engine."""
    max_batched_tokens: int = 512      # chunked-prefill token budget B
    max_slots: int = 64                # resident request limit
    block_size: int = 16               # KV block granularity N_size
    num_kv_blocks: int = 4096          # KV pool size (from device HBM budget)
    prefill_only: bool = False         # disaggregated prefill instance
    decode_only: bool = False          # disaggregated decode instance
    sched_policy: str = "fcfs"         # see repro_torch.scheduling.SCHEDULERS
    skip_ahead: Optional[bool] = None  # None -> policy default (fcfs: off)
    lazy_kv: Optional[bool] = None     # None -> policy default (fcfs: off)
    prefix_cache: bool = False         # shared-prefix KV reuse (off = seed)
    executor: str = "null"             # compute backend: null | real | paged
    host_kv_blocks: int = 0            # host-memory cache tier (0 = off)


class Engine:
    # trailing window (simulated seconds) over which busy_fraction() is
    # measured — the utilization signal the autoscaler's scale-down
    # hysteresis reads. Class attribute so tests can tighten it.
    """One serving instance: scheduler, allocator, executor and clock."""
    BUSY_WINDOW = 20.0

    def __init__(self, name: str, cfg, engine_cfg: EngineConfig, device_model,
                 executor):
        self.name = name
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.device = device_model
        self.executor = executor
        self.clock = 0.0
        self.allocator = BlockAllocator(engine_cfg.num_kv_blocks,
                                        engine_cfg.block_size,
                                        prefix_cache=engine_cfg.prefix_cache,
                                        host_blocks=engine_cfg.host_kv_blocks)
        self.scheduler = make_scheduler(engine_cfg.sched_policy, engine_cfg)
        self.slots: List[Optional[Request]] = [None] * engine_cfg.max_slots
        # Block-pool executors bind to the engine so attention can read
        # the live block tables (and the allocator's CoW hook can clone
        # pool rows). Slot/null executors have no such coupling.
        if hasattr(executor, "attach_engine"):
            executor.attach_engine(self)
        self.queue: Deque[Request] = deque()
        self.finished: List[Request] = []
        self.completed_prefills: List = []   # (time, req) from prefill-only role
        self.n_preemptions = 0               # recompute preemptions served
        # busy-time accounting for the autoscaler's utilization signal:
        # every executed iteration appends (end_clock, duration) here; the
        # log is pruned to BUSY_WINDOW seconds so busy_fraction() stays O(1)
        # amortised. busy_since marks when this engine joined the cluster
        # (reset by InferenceService.attach_endpoint), so a freshly
        # attached engine's fraction is over its own lifetime, not the
        # cluster's. Pure bookkeeping: never feeds metrics or scheduling.
        self.busy_since = 0.0
        self._work_log: Deque = deque()      # (end_clock, duration)
        # per-token emission hook for streaming consumers (InferenceService):
        # called as on_token(request, token_id, clock) at the moment each
        # output token's timestamp is recorded. None = no overhead.
        self.on_token = None
        # flight-recorder hook (repro_torch.obs): InferenceService.start_trace
        # sets tracer + this engine's track handle. None = zero overhead —
        # every tracing site sits behind an `is not None` guard, so an
        # untraced run allocates nothing on this path.
        self.tracer = None
        self.trace_track = 0

    def _emit(self, req: Request, token: int):
        if self.on_token is not None:
            self.on_token(req, token, self.clock)

    def _trace_gauges(self, tracer):
        """Per-iteration gauge samples (tracing on only): queue depth,
        free KV blocks, trailing busy fraction."""
        resident = sum(1 for r in self.slots if r is not None)
        tracer.counter(self.trace_track, "queue_depth", self.clock,
                       {"queued": len(self.queue), "resident": resident})
        tracer.counter(self.trace_track, "free_kv_blocks", self.clock,
                       {"free": self.allocator.num_free})
        tracer.counter(self.trace_track, "busy_frac", self.clock,
                       {"busy": self.busy_fraction()})

    # ------------------------------------------------------------------
    # busy-time accounting (autoscaler utilization signal)
    # ------------------------------------------------------------------
    def _record_work(self, duration: float):
        if duration <= 0.0:
            return
        self._work_log.append((self.clock, duration))
        horizon = self.clock - self.BUSY_WINDOW
        while self._work_log and self._work_log[0][0] < horizon:
            self._work_log.popleft()

    def busy_fraction(self, window: Optional[float] = None) -> float:
        """Fraction of the trailing ``window`` simulated seconds this
        engine spent executing iterations (1.0 = saturated). The window
        is clipped to the engine's own lifetime (``busy_since``) so a
        freshly attached engine isn't reported idle for time it did not
        exist."""
        window = self.BUSY_WINDOW if window is None else window
        lo = max(self.clock - window, self.busy_since)
        span = self.clock - lo
        if span <= 0.0:
            return 0.0
        busy = sum(min(end, self.clock) - max(end - dur, lo)
                   for end, dur in self._work_log
                   if end > lo)
        return min(busy / span, 1.0)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def add_request(self, req: Request, now: Optional[float] = None):
        """Queue ``req`` on this engine (advancing the clock to ``now``)."""
        if now is not None:
            self.clock = max(self.clock, now)
        req.state = ReqState.WAITING
        self.queue.append(req)

    def _view(self) -> SchedulerView:
        return SchedulerView(clock=self.clock, slots=self.slots,
                             queue=self.queue, allocator=self.allocator,
                             cfg=self.ecfg)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def _place(self, req: Request):
        """Queue -> slot, per the plan (blocks reserved per the policy:
        full final context for conservative policies, prompt-only for lazy
        ones, which then grow via ``extend_to``). With prefix caching the
        block table is seeded from the cache first: every reused token
        advances ``context_len`` past its prefill. The last prompt token
        is never taken from the cache — its chunk computes the first
        output token."""
        slot = self._free_slot()
        assert slot is not None, "plan admitted with no free slot"
        if req.metrics.service_start_time is None:
            # first slot admission anywhere (PPI prefill views share the
            # metrics object; preemption-recompute re-placements keep the
            # original): the queueing/service boundary of TTFT
            req.metrics.service_start_time = self.clock
            if self.tracer is not None:
                self.tracer.instant(self.trace_track, "service_start",
                                    self.clock, {"req": req.req_id})
        if self.allocator.prefix_cache and req.input_len > 1:
            if req.context_len == 0 and req.kv_payload is None:
                shared = self.allocator.share_blocks(
                    req.req_id, req.prompt, max_tokens=req.input_len - 1)
                if shared:
                    req.context_len = shared
                    req.metrics.cached_prefix_tokens += shared
                    if self.tracer is not None:
                        self.tracer.instant(
                            self.trace_track, "prefix_hit", self.clock,
                            {"req": req.req_id, "tokens": shared})
            elif req.kv_payload is not None \
                    and req.context_len < req.input_len:
                # Cronus handoff mid-prompt: the cache may hold a longer
                # prefix than the PPI's partial — sharing it shortens the
                # chunked remainder too (fully-covered blocks dedupe even
                # when the match is shorter than the payload)
                shared = self.allocator.share_blocks(
                    req.req_id, req.prompt, max_tokens=req.input_len - 1)
                if shared > req.context_len:
                    req.metrics.cached_prefix_tokens += \
                        shared - req.context_len
                    if self.tracer is not None:
                        self.tracer.instant(
                            self.trace_track, "prefix_hit", self.clock,
                            {"req": req.req_id,
                             "tokens": shared - req.context_len})
                    req.context_len = shared
        # migrated decoders can carry more context than the policy's
        # admission reservation (context covers generated tokens too) —
        # the table must span the payload about to be injected
        need = max(self.scheduler.admission_tokens(req), req.context_len)
        if self.allocator.owned_blocks(req.req_id):
            self.allocator.extend_to(req.req_id, need)
        else:
            self.allocator.allocate(req.req_id, need)
        req.slot = slot
        self.slots[slot] = req
        self.executor.reset_slot(slot)
        if req.kv_payload is not None:
            req.state = ReqState.TRANSFER        # ingest during next iter
        elif req.context_len >= req.input_len:
            req.state = ReqState.RUNNING          # pre-prefilled elsewhere
        else:
            req.state = ReqState.PREFILL

    def _preempt(self, req: Request):
        """Preemption-by-recompute (vLLM-style): release the slot and all
        KV blocks, fold the generated tokens into the prompt (so the
        re-prefill reproduces the full context and the next completion
        token continues the sequence), and requeue at the front."""
        self.n_preemptions += 1
        if self.tracer is not None:
            self.tracer.instant(self.trace_track, "preempt", self.clock,
                                {"req": req.req_id,
                                 "folded_tokens": len(req.generated)})
        req.preempted = True
        if req.generated:
            req.prompt = np.concatenate(
                [req.prompt, np.asarray(req.generated, np.int32)])
            req.output_len -= len(req.generated)
            req.generated = []
        req.context_len = 0
        req.kv_payload = None
        self.allocator.free(req.req_id)
        self.executor.reset_slot(req.slot)
        self.slots[req.slot] = None
        req.slot = None
        req.state = ReqState.WAITING
        req.ready_time = self.clock
        self.queue.appendleft(req)

    def _apply(self, plan: IterationPlan):
        for r in plan.preempt:
            self._preempt(r)
        if plan.admit:
            admit_ids = {id(r) for r in plan.admit}
            self.queue = deque(r for r in self.queue
                               if id(r) not in admit_ids)
            for req in plan.admit:
                self._place(req)

    # ------------------------------------------------------------------
    # stats for the Balancer (paper step (1))
    # ------------------------------------------------------------------
    def stats(self) -> CPIStats:
        # Imminent decode load the Balancer must see, or it under-splits
        # right after a handoff: besides RUNNING residents this counts
        # TRANSFER residents whose context already covers the prompt —
        # they ingest and decode this very iteration.
        """Load snapshot the Balancer reads (paper step (1))."""
        decoding = [r for r in self.slots if r and (
            r.state == ReqState.RUNNING
            or (r.state == ReqState.TRANSFER
                and r.context_len >= r.input_len))]
        imminent = []
        if self.scheduler.lazy_kv:
            # Honest-accounting mode (lazy policies only): delivered
            # handoffs still queued — ready, fully prefilled — decode as
            # soon as a slot frees, so count them up to the free-slot
            # capacity. Conservative policies keep the seed's exact
            # signal: the fcfs bit-identity contract covers the Balancer's
            # inputs, and its split decisions are calibrated to them.
            cap = sum(1 for s in self.slots if s is None)
            if cap:
                imminent = [r for r in self.queue
                            if r.ready_time <= self.clock
                            and r.context_len >= r.input_len][:cap]
        return CPIStats(
            n_decode=len(decoding) + len(imminent),
            decode_ctx_sum=float(sum(r.total_ctx for r in decoding)
                                 + sum(r.total_ctx for r in imminent)),
            free_kv_blocks=self.allocator.num_free,
            block_size=self.ecfg.block_size,
            max_batched_tokens=self.ecfg.max_batched_tokens,
        )

    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        """Whether an iteration would do anything now."""
        if self.queue and self._free_slot() is not None:
            return True
        return any(r is not None for r in self.slots)

    def runnable(self) -> bool:
        """True if step() would make progress right now."""
        if any(r is not None for r in self.slots):
            return True
        if self.queue and self._free_slot() is not None:
            return self.scheduler.has_admissible(self._view())
        return False

    def next_ready_time(self) -> Optional[float]:
        """If idle but queued work is in transit, when it becomes ready."""
        if any(r is not None for r in self.slots) or not self.queue:
            return None
        return self.scheduler.next_ready_time(self._view())

    # ------------------------------------------------------------------
    # one iteration
    # ------------------------------------------------------------------
    def step(self) -> float:
        """Execute one iteration; returns its simulated duration (s)."""
        with host.span("engine.step") as sp:
            return self._step(sp)

    def _step(self, sp) -> float:
        tracer = self.tracer
        t_start = self.clock
        plan = self.scheduler.plan(self._view())
        if tracer is not None:
            n_admit, n_preempt = len(plan.admit), len(plan.preempt)
        self._apply(plan)

        # --- ingest pending KV transfers (overlapped with compute) -------
        transfer_time = 0.0
        ttft_at_ingest: List[Request] = []
        for r in self.slots:
            if r and r.state == ReqState.TRANSFER:
                self.executor.inject_kv(r.slot, r.kv_payload, r.context_len)
                if not r.local_payload:   # decode-offload: KV never moved
                    # the payload holds the PPI's partial_len tokens; a
                    # prefix-cache hit may have advanced context_len past
                    # it, but only the payload actually crosses the wire
                    moved = r.partial_len if r.partial_len else r.context_len
                    wire = self.device.transfer_time(moved)
                    transfer_time = max(transfer_time, wire)
                    if tracer is not None:
                        tracer.instant(self.trace_track, "kv_ingest",
                                       t_start, {"req": r.req_id,
                                                 "tokens": moved,
                                                 "wire_s": wire})
                r.kv_payload = None
                r.state = (ReqState.RUNNING if r.context_len >= r.input_len
                           else ReqState.PREFILL)
                if r.state is ReqState.RUNNING and r.first_token is not None:
                    # fully-prefilled elsewhere (disagg / Cronus fallback):
                    # TTFT counts the KV transfer (paper §5.1 fairness rule)
                    r.generated.append(r.first_token)
                    ttft_at_ingest.append(r)

        # a handoff whose ingest completed its whole output (output_len
        # fully produced elsewhere, e.g. 1-token outputs) must not decode
        # again — it finishes in the ttft_at_ingest handling below
        decode_reqs = [r for r in plan.decode if not r.done]
        if self.scheduler.lazy_kv:
            # dynamic paged-KV growth: each decoder's allocation must cover
            # its next token (the planner preempted victims so this fits)
            for r in decode_reqs:
                self.allocator.extend_to(r.req_id, r.total_ctx)

        # host-tier PCIe traffic this iteration generated (placements
        # promoting demoted chains, allocations demoting cold ones) is
        # DMA overlapped with compute, like the link transfers above
        if self.allocator.host_blocks:
            moved = self.allocator.take_pending_host_transfer_tokens()
            if moved:
                transfer_time = max(transfer_time,
                                    self.device.host_kv_time(moved))

        # Executed chunk lengths clamp to prefill_remaining as it stands
        # AFTER placement: a prefix-cache hit at _place advanced
        # context_len past the plan's view, so only the uncached tail runs
        # (and only it is charged below). Without caching the clamp is a
        # no-op and the executed chunks equal the plan's.
        chunks = [(c.req, n) for c in plan.prefill
                  if (n := min(c.chunk_len, c.req.prefill_remaining)) > 0]

        # chunk provenance for the trace, captured BEFORE execution moves
        # context_len: a chunk is *migrated prefill* — the remainder of a
        # prefill whose head ran elsewhere and crossed the wire — iff the
        # request carries a nonzero partial split, its KV actually moved
        # (not a local decode-offload), it is not a preemption recompute
        # (those restart from context 0 on local KV), and the chunk starts
        # at or past the split point. PPI-side views carry the same
        # partial_len but chunk below it, so they never count.
        if tracer is not None:
            chunk_info = [
                [r.req_id, n, r.context_len,
                 1 if (r.partial_len > 0 and not r.local_payload
                       and not r.preempted
                       and r.context_len >= r.partial_len) else 0]
                for r, n in chunks]
            migrated_tokens = sum(c[1] for c in chunk_info if c[3])
        if sp:
            sp.args = {"engine": self.name, "decode": len(decode_reqs),
                       "prefill_tokens": sum(n for _, n in chunks)}

        if not chunks and not decode_reqs:
            # idle iteration (only transfers); ingest-completed requests
            # still pay the transfer before finishing (TTFT fairness rule)
            if ttft_at_ingest:
                self.clock += transfer_time
                for r in ttft_at_ingest:
                    r.metrics.first_token_time = self.clock
                    if tracer is not None:
                        tracer.instant(self.trace_track, "first_token",
                                       self.clock, {"req": r.req_id})
                    self._emit(r, r.generated[-1])
                    r.metrics.finish_time = self.clock
                    self._finish(r)
            self._record_work(transfer_time)
            if tracer is not None and transfer_time > 0.0:
                tracer.complete(
                    self.trace_track, "iter", t_start, self.clock,
                    {"n_decode": 0, "prefill_tokens": 0,
                     "migrated_prefill_tokens": 0, "n_admit": n_admit,
                     "n_preempt": n_preempt, "transfer_s": transfer_time,
                     "chunks": []})
                self._trace_gauges(tracer)
            return transfer_time

        # --- execute prefill chunks (possibly several requests) -----------
        prefill_tokens = sum(n for _, n in chunks)
        if len(chunks) == 1:
            prefill_ctx: float = chunks[0][0].context_len
        elif chunks:
            # token-weighted mean context start for the roofline attn term
            prefill_ctx = sum(n * r.context_len
                              for r, n in chunks) / prefill_tokens
        else:
            prefill_ctx = 0
        first_tokens: Dict[str, Optional[int]] = {}
        for r, n in chunks:
            tokens = r.prompt[r.context_len: r.context_len + n]
            completes = r.context_len + n >= r.input_len
            first = self.executor.prefill_chunk(
                r.slot, tokens, r.context_len, completes,
                enc_emb=r.enc_emb if r.context_len == 0 else None)
            r.context_len += n
            if completes:
                first_tokens[r.req_id] = first

        if decode_reqs:
            slot_tokens, slot_lens = {}, {}
            for r in decode_reqs:
                # feed the last generated token; its cache position is
                # input_len + (#generated - 1)
                slot_tokens[r.slot] = r.generated[-1]
                slot_lens[r.slot] = r.total_ctx - 1
            new_tokens = self.executor.decode(slot_tokens, slot_lens)

        # --- timing -------------------------------------------------------
        decode_ctx_sum = float(sum(r.total_ctx for r in decode_reqs))
        duration = self.device.chunked_iter_time(
            prefill_tokens, prefill_ctx, decode_ctx_sum, len(decode_reqs))
        duration = max(duration, transfer_time)
        self.clock += duration
        self._record_work(duration)
        if tracer is not None:
            tracer.complete(
                self.trace_track, "iter", t_start, self.clock,
                {"n_decode": len(decode_reqs),
                 "decode_ctx": decode_ctx_sum,
                 "prefill_tokens": prefill_tokens,
                 "migrated_prefill_tokens": migrated_tokens,
                 "n_admit": n_admit, "n_preempt": n_preempt,
                 "transfer_s": transfer_time, "chunks": chunk_info})
            self._trace_gauges(tracer)
        for r in ttft_at_ingest:
            r.metrics.first_token_time = self.clock
            if tracer is not None:
                tracer.instant(self.trace_track, "first_token",
                               self.clock, {"req": r.req_id})
            self._emit(r, r.generated[-1])
            if r.done:
                r.metrics.finish_time = self.clock
                self._finish(r)

        # --- bookkeeping ----------------------------------------------------
        for r, _ in chunks:
            if r.context_len < r.input_len:
                continue
            first = first_tokens[r.req_id]
            # output_len == 0 <=> a PPI prefill view; an offloaded decoder
            # recomputing after preemption carries output_len > 0 and must
            # take the normal token-emitting path even on a prefill-only
            # instance
            if self.ecfg.prefill_only and r.output_len == 0:
                r.first_token = first
                r.metrics.first_token_time = self.clock
                if tracer is not None:
                    # PPI prefill view: views share the original's metrics
                    # object, so this timestamp is later superseded by the
                    # CPI's — the report keeps the last one, matching the
                    # overwrite semantics below
                    tracer.instant(self.trace_track, "first_token",
                                   self.clock, {"req": r.req_id})
                self._complete_prefill_instance(r)
            else:
                r.first_token = first
                r.generated.append(first)   # first output token
                self._emit(r, first)
                if r.preempted and r.input_len > r.metrics.input_len:
                    # recompute after a preemption that folded delivered
                    # tokens into the prompt (input_len grew past the
                    # original): TTFT already happened for real, this
                    # completion token is an inter-token interval
                    r.metrics.token_times.append(self.clock)
                else:
                    # TTFT is this completion — overwriting a PPI-side
                    # timestamp for Cronus partial prefills (views share
                    # the metrics object), as the seed did; a request
                    # preempted mid-prefill before emitting any token
                    # lands here too, so a stale PPI timestamp can never
                    # masquerade as a delivered TTFT
                    r.metrics.first_token_time = self.clock
                    if tracer is not None:
                        tracer.instant(self.trace_track, "first_token",
                                       self.clock, {"req": r.req_id})
                if r.done:
                    r.metrics.finish_time = self.clock
                    self._finish(r)
                else:
                    r.state = ReqState.RUNNING

        if decode_reqs:
            for r in decode_reqs:
                tok = new_tokens[r.slot]
                r.generated.append(tok)
                self._emit(r, tok)
                if r.done:
                    r.metrics.token_times.append(self.clock)
                    r.metrics.finish_time = self.clock
                    self._finish(r)
                else:
                    r.metrics.token_times.append(self.clock)
        return duration

    # ------------------------------------------------------------------
    def _finish(self, req: Request):
        if self.tracer is not None:
            self.tracer.instant(self.trace_track, "finish", self.clock,
                                {"req": req.req_id,
                                 "n_generated": len(req.generated)})
            self.tracer.async_end(self.tracer.control, "request",
                                  self.clock, req.req_id)
        req.state = ReqState.FINISHED
        if self.allocator.prefix_cache:
            # register the finished sequence (prompt + generated) in the
            # prefix index: its blocks are retained as evictable cache
            seq = (np.concatenate([req.prompt,
                                   np.asarray(req.generated, np.int32)])
                   if req.generated else req.prompt)
            self.allocator.free(req.req_id, cache_tokens=seq)
        else:
            self.allocator.free(req.req_id)
        self.executor.reset_slot(req.slot)
        self.slots[req.slot] = None
        req.slot = None
        self.finished.append(req)

    def remove_request(self, req_id: str) -> Optional[Request]:
        """Pull a queued or resident request out of this engine: release
        its slot and KV blocks without touching its metrics or terminal
        state (the caller decides whether this is a cancellation or a
        migration). Returns the request, or None if this engine does not
        hold it. Call between iterations only (plans hold no state across
        ``step()`` calls)."""
        for i, r in enumerate(self.queue):
            if r.req_id == req_id:
                del self.queue[i]
                self.allocator.free(req_id)    # no-op when nothing is owned
                return r
        for r in self.slots:
            if r is not None and r.req_id == req_id:
                self.allocator.free(req_id)
                self.executor.reset_slot(r.slot)
                self.slots[r.slot] = None
                r.slot = None
                return r
        return None

    def cancel(self, req_id: str) -> Optional[Request]:
        """Abort a queued or resident request mid-flight: release its slot
        and KV blocks (nothing is registered in the prefix cache — the
        sequence never completed) and record the ``cancelled`` terminal
        state in its metrics. Returns the request, or None if this engine
        does not hold it."""
        r = self.remove_request(req_id)
        return self._cancel(r) if r is not None else None

    def drain_requests(self) -> List[Request]:
        """Evict everything this engine holds for recompute elsewhere
        (endpoint detach): residents leave via the preemption-by-recompute
        path (generated tokens folded into the prompt, KV freed), then the
        whole queue — including requests the preemptions just requeued —
        is popped and stripped of engine-local state (payloads, partial
        prefills, first tokens) because the KV they reference lives on the
        hardware being removed. Returns the displaced requests; afterwards
        the engine holds no work and its allocator invariants are clean."""
        for r in list(self.slots):
            if r is not None:
                self._preempt(r)
        displaced = []
        while self.queue:
            r = self.queue.popleft()
            r.kv_payload = None
            r.local_payload = False
            r.first_token = None
            r.partial_len = 0
            r.context_len = 0
            r.state = ReqState.WAITING
            r.ready_time = r.arrival
            self.allocator.free(r.req_id)      # no-op when nothing is owned
            displaced.append(r)
        return displaced

    def migrate_requests(self) -> List[Request]:
        """Evict everything this engine holds, *keeping KV where it can
        move* (endpoint detach with migration): residents leave with their
        cache contents extracted into a portable ``kv_payload`` (decoders
        carry ``total_ctx - 1`` tokens, mid-prefill requests their partial
        context) instead of recomputing; queued requests that already
        carry a payload keep it. The runtime routes the displaced requests
        to endpoints that can ingest the KV — and strips the payload back
        to the recompute path when none can. Afterwards the engine holds
        no work and its allocator invariants are clean."""
        displaced: List[Request] = []
        for r in list(self.slots):
            if r is not None:
                displaced.append(self._extract_resident(r))
        while self.queue:
            r = self.queue.popleft()
            self.allocator.free(r.req_id)   # no-op when nothing is owned
            if r.kv_payload is None:
                # plain queued arrival: nothing engine-local to preserve
                r.first_token = None
                r.partial_len = 0
                r.context_len = 0
                r.ready_time = r.arrival
            # else: a delivered handoff's payload is portable data — keep
            # its context/partial/first-token exactly as the PPI left them
            r.local_payload = False
            r.state = ReqState.WAITING
            displaced.append(r)
        return displaced

    def _extract_resident(self, r: Request) -> Request:
        """Pull one resident out with its KV as a portable payload (or
        stripped for recompute when the cache holds nothing yet)."""
        if r.state is ReqState.TRANSFER:
            # the un-ingested payload is already portable: keep it
            r.ready_time = max(r.ready_time, self.clock)
        else:
            # decoders: KV covers total_ctx - 1 (the newest token's KV is
            # written by its own decode step); prefills: context_len
            k = r.total_ctx - 1 if r.generated else r.context_len
            if k > 0:
                r.kv_payload = self.executor.extract_kv(r.slot, k)
                r.context_len = k
                r.partial_len = 0       # the whole payload crosses the wire
                if r.generated:
                    r.first_token = None    # already emitted — never re-emit
                r.ready_time = max(r.ready_time, self.clock)
            else:
                r.kv_payload = None
                r.first_token = None
                r.partial_len = 0
                r.context_len = 0
                r.ready_time = r.arrival
        r.local_payload = False
        self.allocator.free(r.req_id)
        self.executor.reset_slot(r.slot)
        self.slots[r.slot] = None
        r.slot = None
        r.state = ReqState.WAITING
        return r

    def _cancel(self, req: Request) -> Request:
        self.allocator.free(req.req_id)    # no-op when nothing is owned
        req.kv_payload = None
        req.state = ReqState.CANCELLED
        req.metrics.cancelled = True
        req.metrics.cancel_time = self.clock
        if self.tracer is not None:
            self.tracer.instant(self.trace_track, "cancel", self.clock,
                                {"req": req.req_id})
            self.tracer.async_end(self.tracer.control, "request",
                                  self.clock, req.req_id,
                                  {"cancelled": True})
        return req

    def _complete_prefill_instance(self, req: Request):
        """Prefill-only instance: extract KV and release the slot; the
        orchestrator routes the payload to the decode instance. With
        prefix caching the prefilled prompt is registered, so repeated
        shared prefixes shorten the PPI's split-prefill portion too."""
        req.kv_payload = self.executor.extract_kv(req.slot, req.context_len)
        if self.allocator.prefix_cache:
            self.allocator.free(req.req_id,
                                cache_tokens=req.prompt[:req.context_len])
        else:
            self.allocator.free(req.req_id)
        self.slots[req.slot] = None
        req.slot = None
        req.state = ReqState.WAITING
        self.completed_prefills.append((self.clock, req))
