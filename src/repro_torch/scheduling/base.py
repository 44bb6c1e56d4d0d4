"""Iteration-level scheduler: policy-driven batch composition.

One :class:`Scheduler` instance lives inside each :class:`~repro_torch.core.engine.
Engine`. Every iteration the engine hands it a read-only
:class:`SchedulerView` (slots / queue / allocator / config / clock) and gets
back an :class:`IterationPlan` — which queued requests to admit, which
resident requests to preempt (recompute), which requests decode, and which
prefill chunks run, possibly several requests packed into one token budget.
The engine *executes* the plan; it no longer decides batch composition.

Two orthogonal knobs every policy composes:

  * **KV reservation** (``lazy_kv``): conservative policies reserve blocks
    for the full ``input_len + output_len`` at admission (the seed engine's
    behaviour — safe, never preempts, but wildly pessimistic for the
    free-block signal the Balancer's Algorithm 1 reads). Lazy policies
    reserve only the prompt (+1 token) and grow the allocation via
    ``BlockAllocator.extend_to`` as decode advances; when growth hits OOM
    the plan preempts low-priority requests by *recompute* (vLLM-style:
    release KV, fold generated tokens into the prompt, re-prefill later).
  * **Skip-ahead admission** (``skip_ahead``): whether a queued request
    that is ready and allocatable may be admitted past a blocked head
    (e.g. one still in PPI->CPI transit). Off for strict FCFS.

Planning happens *before* the engine ingests pending KV transfers, so the
scheduler reasons about post-ingest ("effective") states: a TRANSFER
request whose context already covers its prompt decodes this very
iteration, one that does not becomes a prefill candidate.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core.request import ReqState, Request


def effective_state(req: Request) -> ReqState:
    """The state a request reaches after KV ingest / admission this
    iteration (TRANSFER and WAITING resolve by context coverage)."""
    if req.state in (ReqState.WAITING, ReqState.TRANSFER):
        return (ReqState.RUNNING if req.context_len >= req.input_len
                else ReqState.PREFILL)
    return req.state


@dataclasses.dataclass
class PrefillChunk:
    """One request's prefill chunk in an iteration."""
    req: Request
    chunk_len: int


@dataclasses.dataclass
class IterationPlan:
    """What one engine iteration executes."""
    admit: List[Request] = dataclasses.field(default_factory=list)
    preempt: List[Request] = dataclasses.field(default_factory=list)
    decode: List[Request] = dataclasses.field(default_factory=list)
    prefill: List[PrefillChunk] = dataclasses.field(default_factory=list)

    @property
    def n_prefill_tokens(self) -> int:
        """Prefill tokens this iteration runs."""
        return sum(c.chunk_len for c in self.prefill)


@dataclasses.dataclass
class SchedulerView:
    """Read-only engine state a policy plans against."""
    clock: float
    slots: Sequence[Optional[Request]]
    queue: Sequence[Request]
    allocator: object          # repro_torch.kvcache.BlockAllocator
    cfg: object                # repro_torch.core.engine.EngineConfig

    def free_slot_indices(self, preempt: Sequence[Request] = ()) -> List[int]:
        """Slots free now or after ``preempt`` is evicted."""
        gone = {id(r) for r in preempt}
        return [i for i, r in enumerate(self.slots)
                if r is None or id(r) in gone]

    def residents(self, admit: Sequence[Request] = (),
                  preempt: Sequence[Request] = ()) -> List[Request]:
        """Resident requests after applying ``admit``/``preempt``, in slot
        order. Admissions fill free slots lowest-index-first in admit
        order — exactly how the engine assigns slots, so the plan's
        request ordering matches the executed one."""
        gone = {id(r) for r in preempt}
        occ = {i: r for i, r in enumerate(self.slots)
               if r is not None and id(r) not in gone}
        for i, req in zip(self.free_slot_indices(preempt), admit):
            occ[i] = req
        return [occ[i] for i in sorted(occ)]


class Scheduler(abc.ABC):
    """Batch-composition policy. Subclasses set the class knobs and
    override the ordering hooks; the template methods below do the
    slot/block accounting once, identically to how the engine applies
    the plan."""

    name: str = "?"
    default_skip_ahead = False     # may queued requests pass a blocked head?
    default_lazy_kv = False        # lazy paged-KV growth (vs full reserve)
    max_prefill_seqs: Optional[int] = None   # None = pack until budget spent

    def __init__(self, cfg):
        self.cfg = cfg
        self.skip_ahead = (cfg.skip_ahead if cfg.skip_ahead is not None
                           else self.default_skip_ahead)
        self.lazy_kv = (cfg.lazy_kv if cfg.lazy_kv is not None
                        else self.default_lazy_kv)
        if cfg.decode_only:
            # a decode-only instance has no prefill path, so preemption-
            # by-recompute is unavailable; reserve conservatively instead
            self.lazy_kv = False

    # ------------------------------------------------------------------
    # ordering hooks (the policy)
    # ------------------------------------------------------------------
    def admission_order(self, queue: Sequence[Request]) -> List[Request]:
        """Queue scan order for admission (default: FIFO)."""
        return list(queue)

    def prefill_order(self, cands: List[Request]) -> List[Request]:
        """Order in which prefill candidates claim token budget
        (default: slot order, i.e. admission order)."""
        return cands

    def victim_order(self, decode: List[Request]) -> List[Request]:
        """Preemption victims, first victim first (default: newest
        arrival goes first, vLLM's recompute discipline)."""
        return sorted(decode, key=lambda r: (r.arrival, r.req_id),
                      reverse=True)

    # ------------------------------------------------------------------
    # KV accounting
    # ------------------------------------------------------------------
    def admission_tokens(self, req: Request) -> int:
        """Tokens' worth of KV blocks reserved when admitting ``req``."""
        if self.lazy_kv:
            # prompt + the first generated token; decode growth extends
            return req.input_len + (1 if req.output_len > 0 else 0)
        return req.input_len + req.output_len        # seed behaviour

    def watermark_blocks(self, view: SchedulerView) -> int:
        """Free-block headroom lazy admission keeps back to damp
        admit->OOM->preempt thrash (vLLM's 1% watermark)."""
        if not self.lazy_kv:
            return 0
        return max(1, view.allocator.num_blocks // 100)

    # ------------------------------------------------------------------
    # template: the plan
    # ------------------------------------------------------------------
    def plan(self, view: SchedulerView) -> IterationPlan:
        """Compose the next iteration's plan from ``view``."""
        preempt: List[Request] = []
        if self.lazy_kv:
            running = [r for r in view.residents()
                       if effective_state(r) is ReqState.RUNNING]
            preempt = self._preempt_for_growth(view, running)
        admit = self.select_admissions(view, preempt)
        residents = view.residents(admit, preempt)
        decode = [r for r in residents
                  if effective_state(r) is ReqState.RUNNING]
        prefill = self.pack_prefill(view, residents, decode)
        return IterationPlan(admit=admit, preempt=preempt, decode=decode,
                             prefill=prefill)

    def select_admissions(self, view: SchedulerView,
                          preempt: Sequence[Request] = ()) -> List[Request]:
        """Queue -> slots this iteration, simulating the exact slot and
        block bookkeeping the engine will perform."""
        admit: List[Request] = []
        free_slots = len(view.free_slot_indices(preempt))
        free_blocks = view.allocator.num_free
        if self.lazy_kv:
            # blocks the surviving decoders will claim via extend_to
            preempt_ids = {id(r) for r in preempt}
            for r in view.residents():
                if (effective_state(r) is ReqState.RUNNING
                        and id(r) not in preempt_ids):
                    free_blocks -= max(
                        0, view.allocator.blocks_needed(r.total_ctx)
                        - view.allocator.owned_blocks(r.req_id))
            for r in preempt:
                free_blocks += view.allocator.owned_blocks(r.req_id)
        watermark = self.watermark_blocks(view)
        any_resident = any(r is not None for r in view.slots) or bool(preempt)
        for req in self.admission_order(view.queue):
            if len(admit) >= free_slots:
                break
            if req.ready_time > view.clock:
                if self.skip_ahead:
                    continue
                break
            if self.lazy_kv and view.allocator.blocks_needed(
                    req.input_len + req.output_len) > view.allocator.num_blocks:
                # the request's final context can never fit even with the
                # pool to itself: growth would OOM with no victim left.
                # Refuse admission — the same stall a conservative policy
                # gives an oversized request, instead of a mid-run crash.
                if self.skip_ahead:
                    continue
                break
            need = view.allocator.blocks_needed(self.admission_tokens(req))
            # the first admission into an idle engine bypasses the
            # watermark so an oversized-but-feasible prompt can't starve
            headroom = watermark if (any_resident or admit) else 0
            if need > free_blocks - headroom:
                if self.skip_ahead:
                    continue
                break
            admit.append(req)
            free_blocks -= need
        return admit

    def planned_prefill_remaining(self, view: SchedulerView,
                                  req: Request) -> int:
        """``prefill_remaining`` as it will stand after this iteration's
        placement: a request admitted from the queue may start past
        context 0 via a prefix-cache hit (the engine seeds its block
        table from the cache in ``_place``), so only the uncached tail
        needs token budget. Read-only probe; without prefix caching this
        is exactly ``prefill_remaining``."""
        rem = req.prefill_remaining
        if (req.state is ReqState.WAITING and req.context_len == 0
                and req.kv_payload is None and req.input_len > 1
                and getattr(view.allocator, "prefix_cache", False)):
            rem -= view.allocator.lookup_prefix(
                req.prompt, max_tokens=req.input_len - 1)
        return max(rem, 0)

    def pack_prefill(self, view: SchedulerView, residents: List[Request],
                     decode: List[Request]) -> List[PrefillChunk]:
        """Fill the token budget left by decodes with prefill chunks —
        one request (fcfs) or several (sarathi/sjf)."""
        if view.cfg.decode_only:
            return []
        budget = view.cfg.max_batched_tokens - len(decode)
        cands = [r for r in residents
                 if effective_state(r) is ReqState.PREFILL]
        chunks: List[PrefillChunk] = []
        for r in self.prefill_order(cands):
            if budget <= 0:
                break
            n = min(self.planned_prefill_remaining(view, r), budget)
            if n <= 0:
                continue
            chunks.append(PrefillChunk(r, n))
            budget -= n
            if (self.max_prefill_seqs is not None
                    and len(chunks) >= self.max_prefill_seqs):
                break
        return chunks

    def _preempt_for_growth(self, view: SchedulerView,
                            running: List[Request]) -> List[Request]:
        """When the decoders' next-token KV growth no longer fits, free
        low-priority requests (recompute) until the survivors fit.
        Mid-prefill residents are the cheapest victims (no generated
        tokens to recompute) and go first; then decoders in policy order.
        The highest-priority decoder is never preempted."""
        alloc = view.allocator
        extra = {r.req_id: max(0, alloc.blocks_needed(r.total_ctx)
                               - alloc.owned_blocks(r.req_id))
                 for r in running}
        total_extra = sum(extra.values())
        free = alloc.num_free
        if total_extra <= free:
            return []
        prefilling = [r for r in view.residents()
                      if effective_state(r) is ReqState.PREFILL]
        # first victim first; [:-1] protects the highest-priority decoder
        pool = (self.victim_order(prefilling)
                + self.victim_order(running)[:-1])
        victims: List[Request] = []
        for v in pool:
            if total_extra <= free:
                break
            victims.append(v)
            free += alloc.owned_blocks(v.req_id)
            total_extra -= extra.get(v.req_id, 0)
        return victims

    # ------------------------------------------------------------------
    # engine probes (runnable / idle-jump)
    # ------------------------------------------------------------------
    def has_admissible(self, view: SchedulerView) -> bool:
        """Would a step make admission progress right now? (Consulted by
        ``Engine.runnable`` only when no request is resident.)"""
        return bool(self.select_admissions(view))

    def next_ready_time(self, view: SchedulerView) -> Optional[float]:
        """Earliest queued ready_time an idle engine should jump to.

        Only *future* times count: this is consulted when the engine is
        idle and ``has_admissible`` said no, so a request that is already
        ready yet still inadmissible (oversized for the pool) can never
        become admissible by jumping the clock — reporting its past
        timestamp would freeze the cluster loop in a no-op-jump livelock.
        """
        cands = (view.queue if self.skip_ahead
                 else [view.queue[0]] if view.queue else [])
        future = [r.ready_time for r in cands if r.ready_time > view.clock]
        return min(future) if future else None
