"""The Cronus PPI+CPI pair as a cluster endpoint.

This is the per-pair protocol of paper §4.2 (steps 1-7), extracted verbatim
from the old ``CronusSystem.run`` loop so that any number of pairs can sit
behind one :class:`~repro_torch.cluster.runtime.ClusterRuntime`:

  (1) on submit, pull CPI stats;
  (2) Balancer chooses the partial prefill length L_p;
  (3) dispatch R[:L_p] to the PPI (<= ``max_ppi_requests`` resident);
  (4) PPI completion surfaces in ``ppi.completed_prefills`` — ``pump``
      turns each into a timed KV-transfer-completion event;
  (5-7) the event delivers the request (with its KV payload) to the CPI,
      whose next iteration ingests the transfer overlapped with compute.

Decode offload (paper §6, bounded by ``max_offload_frac``) keeps requests
whose prefill fell back to the full prompt on the PPI — they re-enter the
PPI as local-payload decoders instead of crossing to the CPI.

The disaggregated baselines are this same endpoint with a FixedBalancer
(partial length pinned to L_in) and a decode-only CPI.

The pair inherits its engines' batch-composition policy
(``EngineConfig.sched_policy``, threaded through ``build_cronus`` /
the topology DSL's ``@policy`` suffix): under a lazy policy the CPI
reserves prompt-only KV and grows it per decode step, which makes the
free-block count the Balancer pulls in step (1) reflect *actual* cache
use instead of the conservative full-context reservation — Alg. 1's
fallback (full prefill on the PPI) then fires only under real pressure.
"""
from __future__ import annotations

import copy
from typing import List, Tuple

from repro_torch.core.engine import Engine
from repro_torch.core.request import ReqState, Request
from repro_torch.cluster.runtime import Endpoint


class CronusPairEndpoint(Endpoint):
    """One PPI+CPI Cronus pair as a routable endpoint: owns the paper's
    per-request protocol (balancer split, ≤2 in the PPI, KV handoff,
    bounded decode offload) over two engines."""

    def __init__(self, name: str, ppi: Engine, cpi: Engine, balancer,
                 max_ppi_requests: int = 2, decode_offload: bool = False,
                 max_offload_frac: float = 0.5):
        self.name = name
        self.ppi = ppi
        self.cpi = cpi
        self.balancer = balancer
        self.max_ppi_requests = max_ppi_requests
        self.decode_offload = decode_offload
        self.max_offload_frac = max_offload_frac
        self._in_ppi = {}       # ppi view req_id -> original request
        self._offloaded = set()

    @property
    def engines(self) -> Tuple[Engine, ...]:
        """(PPI, CPI) — decode engine last by Endpoint convention."""
        # decode engine last: Endpoint.sched_policy / EndpointStats read
        # the pair's policy and free-KV signal from the CPI
        return (self.ppi, self.cpi)

    # ------------------------------------------------------------------
    def _ppi_prefill_load(self) -> int:
        # offloaded decoders don't count against the paper's <=2 cap
        return len(self._in_ppi) + sum(
            1 for r in self.ppi.queue if r.req_id not in self._offloaded
            and r.req_id not in self._in_ppi)

    def can_accept(self, req: Request) -> bool:
        """Whether the PPI has room under the paper's ≤2-requests cap."""
        load = self._ppi_prefill_load()
        if load >= self.max_ppi_requests:
            return False
        # a future arrival may only claim an *idle* PPI (its clock then
        # jumps to the arrival); a busy PPI makes the router wait
        return req.arrival <= self.ppi.clock or load == 0

    def submit(self, req: Request, runtime=None):
        """Dispatch one request through the pair protocol (steps 1-3):
        pull CPI stats, choose the split, start the partial prefill."""
        self.ppi.clock = max(self.ppi.clock, req.arrival)
        stats = self.cpi.stats()                            # step (1)
        l_p = self.balancer.partial_prefill_length(          # step (2)
            req.input_len, stats)
        req.partial_len = int(l_p)
        tracer = runtime.tracer if runtime is not None else None
        if tracer is not None:
            tracer.instant(
                tracer.control, "balancer_split", self.ppi.clock,
                {"req": req.req_id, "endpoint": self.name,
                 "l_p": req.partial_len, "input_len": req.input_len,
                 "cpi_n_decode": stats.n_decode,
                 "cpi_free_kv_blocks": stats.free_kv_blocks})
        if (self.decode_offload and l_p >= req.input_len
                and not self.balancer.__class__.__name__.startswith("Fixed")):
            # Alg. 1 fell back (CPI out of KV blocks) -> offload the whole
            # request to the PPI (§6), but only while the PPI keeps
            # >= (1 - max_offload_frac) of its KV pool free for prefills
            alloc = self.ppi.allocator
            need = alloc.blocks_needed(req.input_len + req.output_len)
            budget = int(alloc.num_blocks * self.max_offload_frac)
            used = alloc.num_blocks - alloc.num_free
            if used + need <= budget:
                self._offloaded.add(req.req_id)
        view = copy.copy(req)                                # step (3)
        view.prompt = req.prompt[:req.partial_len]
        view.output_len = 0
        view.ready_time = req.arrival
        view.state = ReqState.WAITING
        view.context_len = 0
        self._in_ppi[view.req_id] = req
        self.ppi.add_request(view)

    # ------------------------------------------------------------------
    def pump(self, runtime=None):
        """Steps (4-5): each completed PPI prefill becomes a KV-transfer
        completion event that delivers the request to the CPI (or back to
        the PPI for offloaded decoders). The transfer *cost* is charged by
        the receiving engine when it ingests the payload (steps 6-7)."""
        while self.ppi.completed_prefills:
            t_done, view = self.ppi.completed_prefills.pop(0)
            orig = self._in_ppi.pop(view.req_id, None)
            if orig is None:
                continue                     # cancelled while in the PPI
            orig.partial_len = view.context_len
            orig.context_len = view.context_len
            orig.kv_payload = view.kv_payload
            orig.first_token = view.first_token
            orig.ready_time = t_done
            if orig.req_id in self._offloaded:
                orig.local_payload = True        # KV never leaves the PPI
                target, dst = self.ppi, "ppi"
            else:
                target, dst = self.cpi, "cpi"
            if runtime is not None:
                # the cluster transfer engine posts the delivery at t_done
                # and re-checks the terminal state in its closure: a cancel
                # landing between post and drain must not resurrect the
                # request in the receiving queue. Cost stays charge="ingest"
                # — the receiving engine prices the wire when it ingests
                # the payload (steps 6-7), overlapped with compute.
                runtime.transfers.transfer(
                    orig, src=f"{self.name}/ppi", dst=f"{self.name}/{dst}",
                    deliver=target.add_request, when=t_done,
                    n_tokens=0 if orig.local_payload else None,
                    kind="handoff")
            else:
                target.add_request(orig)

    def drain(self) -> List[Request]:
        """Evict the pair's whole population for recompute elsewhere
        (endpoint detach). Requests live in three places:

          * as a *view* in the PPI (queued, mid-prefill, or completed but
            unpumped in ``completed_prefills``) — the view is discarded
            and the original recomputes from scratch (its partial KV
            lives on the departing PPI, so the handoff cannot complete);
          * delivered to the CPI (queued handoff, TRANSFER, PREFILL, or
            decoding) — residents leave via preemption-by-recompute
            (generated tokens folded into the prompt), queued handoffs
            drop their payload;
          * as an offloaded decoder back on the PPI — same as the CPI
            case.

        Returns the displaced originals, stripped of every pair-local
        artifact, ready to re-route anywhere."""
        displaced: List[Request] = []
        for rid, orig in list(self._in_ppi.items()):
            del self._in_ppi[rid]
            self._offloaded.discard(rid)
            if self.ppi.remove_request(rid) is None:
                # the view finished its partial prefill and awaits pump:
                # drop it (its PPI blocks were freed at completion)
                self.ppi.completed_prefills = [
                    (t, v) for t, v in self.ppi.completed_prefills
                    if v.req_id != rid]
            orig.partial_len = 0
            orig.kv_payload = None
            orig.first_token = None
            orig.local_payload = False
            orig.context_len = 0
            orig.state = ReqState.WAITING
            orig.ready_time = orig.arrival
            displaced.append(orig)
        for eng in (self.cpi, self.ppi):
            for r in eng.drain_requests():
                self._offloaded.discard(r.req_id)
                displaced.append(r)
        return displaced

    def migrate(self) -> List[Request]:
        """Detach with KV carried out as migration payloads. PPI prefill
        views with computed KV (completed-but-unpumped handoffs, or
        mid-prefill residents) are folded back into their originals as
        partial payloads — exactly the state a Cronus handoff would have
        shipped — and CPI/PPI residents leave via
        :meth:`~repro_torch.core.engine.Engine.migrate_requests`. Requests with
        nothing extractable strip to recompute, as in :meth:`drain`."""
        displaced: List[Request] = []
        for rid, orig in list(self._in_ppi.items()):
            del self._in_ppi[rid]
            self._offloaded.discard(rid)
            done = next(((t, v) for t, v in self.ppi.completed_prefills
                         if v.req_id == rid), None)
            if done is not None:
                # finished partial prefill awaiting pump: its payload is
                # already extracted — complete the handoff into the
                # original (PPI blocks were freed at completion)
                t_done, view = done
                self.ppi.completed_prefills = [
                    (t, v) for t, v in self.ppi.completed_prefills
                    if v.req_id != rid]
                orig.partial_len = view.context_len
                orig.context_len = view.context_len
                orig.kv_payload = view.kv_payload
                orig.first_token = view.first_token
                orig.ready_time = t_done
            else:
                view = self._find_view(rid)
                k = view.context_len if view is not None else 0
                if k > 0 and view.slot is not None:
                    # mid-prefill resident: carry the chunks computed so
                    # far (extract BEFORE remove frees the block table)
                    orig.kv_payload = self.ppi.executor.extract_kv(
                        view.slot, k)
                    orig.partial_len = k
                    orig.context_len = k
                    orig.first_token = None
                    orig.ready_time = max(orig.arrival, self.ppi.clock)
                else:
                    orig.partial_len = 0
                    orig.kv_payload = None
                    orig.first_token = None
                    orig.context_len = 0
                    orig.ready_time = orig.arrival
                self.ppi.remove_request(rid)
            orig.local_payload = False
            orig.state = ReqState.WAITING
            displaced.append(orig)
        for eng in (self.cpi, self.ppi):
            for r in eng.migrate_requests():
                self._offloaded.discard(r.req_id)
                displaced.append(r)
        return displaced

    def _find_view(self, rid: str):
        for r in self.ppi.slots:
            if r is not None and r.req_id == rid:
                return r
        for r in self.ppi.queue:
            if r.req_id == rid:
                return r
        return None

    def accepts_kv(self, req: Request) -> bool:
        """Migrated KV lands on the CPI directly (the PPI's job — partial
        prefill — already happened on the source), so the PPI admission
        cap doesn't gate it. A decode-only CPI can't chunk-prefill the
        remainder, so there the payload must cover the whole prompt."""
        if self.cpi.ecfg.decode_only and req.context_len < req.input_len:
            return False
        return True

    def submit_kv(self, req: Request, runtime=None):
        """Ingest a migrated request on the decode side."""
        # straight to the CPI, ready_time untouched (the migration
        # transfer gated delivery; ingest prices the wire)
        self.cpi.add_request(req)

    def cancel(self, req: Request) -> bool:
        """Mid-flight cancel across the pair: the request may live as a
        PPI prefill view (queued, resident, or completed-but-unpumped),
        as a delivered handoff on the CPI, or as an offloaded decoder
        back on the PPI."""
        rid = req.req_id
        orig = self._in_ppi.pop(rid, None)
        if orig is not None:
            self._offloaded.discard(rid)
            if self.ppi.cancel(rid) is None:
                # the view already finished its partial prefill and sits
                # in completed_prefills waiting for pump: drop it there
                # (its PPI blocks were freed at completion)
                self.ppi.completed_prefills = [
                    (t, v) for t, v in self.ppi.completed_prefills
                    if v.req_id != rid]
                orig.metrics.cancelled = True
                orig.metrics.cancel_time = self.ppi.clock
                if self.ppi.tracer is not None:
                    tracer = self.ppi.tracer
                    tracer.instant(self.ppi.trace_track, "cancel",
                                   self.ppi.clock, {"req": rid})
                    tracer.async_end(tracer.control, "request",
                                     self.ppi.clock, rid,
                                     {"cancelled": True})
            orig.state = ReqState.CANCELLED
            orig.kv_payload = None
            return True
        for eng in (self.cpi, self.ppi):
            if eng.cancel(rid) is not None:
                return True
        return False

    def finished(self) -> List[Request]:
        """Completions from both engines (offloaded decoders finish on
        the PPI)."""
        return list(self.cpi.finished) + list(self.ppi.finished)

    def n_finished(self) -> int:
        """Count of completions from both engines."""
        return len(self.cpi.finished) + len(self.ppi.finished)
