"""General KV transfer engine: every KV movement through one mechanism.

Mooncake/NIXL-style (SNIPPETS §1): endpoints register their pools with one
cluster-owned :class:`TransferEngine`; every cross-pool KV move — the
Cronus PPI→CPI handoff, detach-time cache migration, cross-endpoint prefix
fetch — is an async ``transfer`` that resolves into the shared event loop.
The engine is a *mechanism*, not a policy: callers decide what moves where;
it owns delivery scheduling, cancellation, cost accounting, and the
observability counters.

Two charge disciplines, matching how the simulation prices movement:

  * ``charge="ingest"`` — delivery fires at ``when`` and the *receiving*
    engine charges ``DeviceModel.transfer_time`` when it ingests the
    payload, overlapped with its compute (the paper's §4.2 steps 6-7;
    bit-identical to the pre-engine Cronus handoff path);
  * ``charge="link"`` — the link time is added to the request's
    ``ready_time`` up front (used for cross-endpoint prefix fetches,
    where no payload ingest follows on the destination).

Cancellation: a handle cancelled mid-flight (or a request reaching
``CANCELLED`` state before delivery) simply never delivers — the source
pool freed its blocks when the payload was extracted, the destination pool
never saw them, so both sides stay clean by construction.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.core.request import ReqState, Request

CHARGE_MODES = ("ingest", "link")


@dataclasses.dataclass
class TransferHandle:
    """One in-flight (or settled) KV transfer."""

    req_id: str
    src: str                   # source pool name (engine/endpoint)
    dst: str                   # destination pool name
    n_tokens: int              # KV tokens crossing
    t_post: float              # simulated time the transfer was issued
    link_time: float           # modeled seconds on the wire
    kind: str = "handoff"      # handoff | migration | prefix_fetch
    state: str = "inflight"    # inflight | delivered | cancelled

    def cancel(self) -> bool:
        """Abort before delivery. True if the transfer was still in
        flight (the delivery event becomes a no-op)."""
        if self.state == "inflight":
            self.state = "cancelled"
            return True
        return False


class TransferEngine:
    """Cluster-wide KV movement: registered pools + async transfers.

    One instance per :class:`~repro_torch.cluster.runtime.ClusterRuntime`; when
    constructed without a runtime (legacy single-system paths) deliveries
    fire synchronously, which preserves the old direct-call semantics.
    """

    def __init__(self, runtime=None):
        self._runtime = runtime
        self._pools: Dict[str, object] = {}       # name -> endpoint
        self._inflight: Dict[str, TransferHandle] = {}
        self.n_transfers = 0
        self.n_cancelled = 0
        self.tokens_moved = 0
        self.tokens_by_kind: Dict[str, int] = {}

    # ------------------------------------------------------------------
    # pool registry
    # ------------------------------------------------------------------
    def register(self, endpoint) -> None:
        """Make ``endpoint``'s KV pools addressable as a transfer source
        or destination."""
        self._pools[endpoint.name] = endpoint

    def deregister(self, name: str) -> None:
        """Drop a detached endpoint's pools from the registry."""
        self._pools.pop(name, None)

    def endpoint(self, name: str):
        """The registered endpoint for ``name`` (None if unknown)."""
        return self._pools.get(name)

    # ------------------------------------------------------------------
    # transfers
    # ------------------------------------------------------------------
    def link_time(self, device_model, n_tokens: int) -> float:
        """Modeled wire time for ``n_tokens`` of KV on ``device_model``'s
        inter-device link."""
        return device_model.transfer_time(n_tokens)

    def transfer(self, req: Request, *, src: str, dst: str,
                 deliver: Callable[[Request], None], when: float,
                 n_tokens: Optional[int] = None, device_model=None,
                 charge: str = "ingest",
                 kind: str = "handoff") -> TransferHandle:
        """Move ``req`` (carrying its KV payload) from pool ``src`` to
        pool ``dst``: schedule ``deliver(req)`` into the event loop at
        ``when`` (plus wire time under ``charge="link"``). The delivery
        closure re-checks cancellation, so a cancel landing between post
        and drain never resurrects the request at the destination."""
        if charge not in CHARGE_MODES:
            raise ValueError(f"unknown charge mode {charge!r}; "
                             f"choose from {CHARGE_MODES}")
        if n_tokens is None:
            n_tokens = req.partial_len if req.partial_len else req.context_len
        link = (self.link_time(device_model, n_tokens)
                if device_model is not None else 0.0)
        handle = TransferHandle(req_id=req.req_id, src=src, dst=dst,
                                n_tokens=int(n_tokens), t_post=when,
                                link_time=link, kind=kind)
        t_arrive = when + link if charge == "link" else when
        if charge == "link":
            req.ready_time = max(req.ready_time, t_arrive)
        self._inflight[handle.req_id] = handle
        self.n_transfers += 1

        def _fire(h=handle, r=req, t=t_arrive):
            if self._inflight.get(h.req_id) is h:
                del self._inflight[h.req_id]
            tracer = getattr(self._runtime, "tracer", None)
            if h.state == "cancelled" or r.state is ReqState.CANCELLED:
                h.state = "cancelled"
                self.n_cancelled += 1
                if tracer is not None:
                    tracer.instant(tracer.track_for(h.src), "kv_cancelled",
                                   t, {"req": h.req_id, "kind": h.kind,
                                       "dst": h.dst})
                return
            h.state = "delivered"
            self.tokens_moved += h.n_tokens
            self.tokens_by_kind[h.kind] = (
                self.tokens_by_kind.get(h.kind, 0) + h.n_tokens)
            if tracer is not None:
                # both halves of the flow arrow are emitted at delivery,
                # so every send pairs with exactly one receive (cancelled
                # transfers surface as kv_cancelled instants instead)
                fid = tracer.new_flow_id()
                args = {"req": h.req_id, "kind": h.kind,
                        "tokens": h.n_tokens, "src": h.src, "dst": h.dst}
                tracer.flow_start(tracer.track_for(h.src), "kv_send",
                                  h.t_post, fid, args)
                tracer.flow_end(tracer.track_for(h.dst), "kv_recv",
                                t, fid, args)
                tracer.counter(tracer.control, "transfer_tokens", t,
                               {h.kind: self.tokens_by_kind[h.kind]})
            deliver(r)

        if self._runtime is not None:
            self._runtime.post(t_arrive, _fire)
        else:
            _fire()
        return handle

    def cancel(self, req_id: str) -> bool:
        """Cancel the in-flight transfer for ``req_id``, if any."""
        h = self._inflight.get(req_id)
        return h.cancel() if h is not None else False

    @property
    def n_inflight(self) -> int:
        """Transfers posted but not yet delivered or cancelled."""
        return len(self._inflight)

    def stats(self) -> Dict[str, float]:
        """Counter snapshot for benchmarks and operator dashboards."""
        out: Dict[str, float] = {
            "n_transfers": self.n_transfers,
            "n_cancelled": self.n_cancelled,
            "n_inflight": self.n_inflight,
            "tokens_moved": self.tokens_moved,
        }
        for kind, n in self.tokens_by_kind.items():
            out[f"tokens_{kind}"] = n
        return out
