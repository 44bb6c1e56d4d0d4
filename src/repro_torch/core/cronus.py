"""Cronus orchestrator (paper §4.2, Fig. 1-2) + the disaggregated baselines.

Topology: frontend (with the Balancer) -> PPI (partial prefill instance,
low-end device, prefill-only) -> KV buffer -> CPI (chunked prefill instance,
high-end device, chunked prefill + all decode).

Protocol per request R_i (paper numbering):
  (1) at dispatch the Balancer pulls CPI stats,
  (2) computes the partial prefill length L_p,
  (3) dispatches R_i[:L_p] to the PPI (PPI holds <= 2 requests),
  (4) PPI completion stores KV in the buffer and notifies the frontend,
  (5) frontend forwards R_i (with partial_len) to the CPI,
  (6-7) the CPI's first iteration for R_i ingests the KV transfer, overlapped
        with other requests' decode/chunked-prefill compute,
  then standard chunked prefill + decode on the CPI.

The disaggregated baselines reuse this code verbatim with the partial
length pinned to L_in (paper §5.1: "the same code as our partial prefill
implementation, but always set the partial prefill length to the input
length"), and the CPI flipped to decode-only. High->Low swaps the devices.

Time is simulated (engines carry local clocks advanced by the device
roofline model); compute is real or null depending on the executor.

The per-pair protocol itself lives in ``repro_torch.cluster.pair`` (so that N
pairs can share one cluster); ``CronusSystem`` is the single-pair facade:
``run()`` wraps the pair in a one-endpoint cluster and replays the trace
through the shared event loop in ``repro_torch.cluster.runtime``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from typing import TYPE_CHECKING

from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.request import Request

if TYPE_CHECKING:  # runtime imports are deferred: cluster.* imports core.*
    from repro_torch.cluster.pair import CronusPairEndpoint


class FixedBalancer:
    """Disaggregated baselines: partial prefill length == input length."""

    def partial_prefill_length(self, l_in: int, stats) -> int:
        """The whole prompt goes to the prefill instance."""
        return l_in


@dataclasses.dataclass
class CronusSystem:
    """One PPI+CPI pair with its balancer: the single-pair facade."""
    ppi: Engine                      # prefill-only, low-end device
    cpi: Engine                      # chunked prefill + decode, high-end
    balancer: object                 # Balancer | FixedBalancer
    max_ppi_requests: int = 2        # paper: at most two in the PPI
    # Decode offload (paper §6 "future work", implemented here): when the
    # CPI lacks KV blocks for a request (Alg. 1's fallback case — the
    # decode-bound regime of short-input/long-output traces), the request
    # completes ENTIRELY on the PPI: full prefill there, then decode there
    # too, with a zero-cost local "transfer". Mitigates the load imbalance
    # the paper identifies in its Limitations section.
    #
    # Policy lesson (bench_offload_limitation, first attempt REFUTED): the
    # fallback condition alone overloads the slow PPI (259/300 requests
    # offloaded -> throughput collapsed 3.4 -> 0.2 req/s, i.e. the system
    # inverted into Disagg-H-L). Offload must be bounded by the PPI's own
    # spare decode capacity — `max_offload_frac` of its KV pool.
    decode_offload: bool = False
    max_offload_frac: float = 0.5

    def endpoint(self, name: str = "cronus") -> "CronusPairEndpoint":
        """This pair as a routable cluster endpoint (fresh handoff state)."""
        from repro_torch.cluster.pair import CronusPairEndpoint
        return CronusPairEndpoint(
            name, self.ppi, self.cpi, self.balancer,
            max_ppi_requests=self.max_ppi_requests,
            decode_offload=self.decode_offload,
            max_offload_frac=self.max_offload_frac)

    def run(self, requests: List[Request], max_steps: int = 10_000_000):
        """Replay ``requests`` through a one-endpoint cluster; aggregate metrics."""
        from repro_torch.cluster.router import RoundRobinRouter
        from repro_torch.cluster.runtime import ClusterRuntime
        # Aggregates over BOTH engines: under decode_offload requests that
        # complete on the PPI count too (they were silently dropped before).
        return ClusterRuntime([self.endpoint()], RoundRobinRouter()).run(
            requests, max_steps)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def build_cronus(cfg, ppi_device, cpi_device, *, executor_factory: Callable,
                 balancer: Optional[object] = None,
                 max_batched_tokens: int = 512,
                 max_slots: int = 64, block_size: int = 16,
                 decode_only_cpi: bool = False,
                 decode_offload: bool = False,
                 sched_policy: str = "fcfs",
                 prefix_cache: bool = False,
                 num_kv_blocks: Optional[int] = None,
                 host_kv_blocks: int = 0,
                 executor: str = "null") -> CronusSystem:
    """executor_factory(role: str) -> executor ('ppi' | 'cpi').

    ``sched_policy`` selects the iteration-level batch-composition policy
    (``repro_torch.scheduling.SCHEDULERS``) for BOTH engines of the pair; the
    default ``fcfs`` reproduces the seed engine bit-for-bit.
    ``prefix_cache`` enables shared-prefix KV reuse on both engines: a
    hit on the PPI shortens its split-prefill portion, a hit on the CPI
    shortens the chunked remainder. ``num_kv_blocks`` overrides the
    device-HBM-derived KV pool size on both engines — required for the
    paged executor, which materializes the pool for real; ``executor``
    records the compute backend in each EngineConfig. ``host_kv_blocks``
    adds a host-memory cache tier of that many blocks to both engines
    (requires ``prefix_cache``): refcount-0 prefix blocks demote to host
    DRAM instead of being dropped, and promote back on a hit, with the
    PCIe cost charged into each engine's iteration time."""
    ppi_blocks = (num_kv_blocks if num_kv_blocks is not None
                  else max(ppi_device.kv_block_budget(block_size), 64))
    cpi_blocks = (num_kv_blocks if num_kv_blocks is not None
                  else max(cpi_device.kv_block_budget(block_size), 64))
    ppi = Engine("ppi", cfg,
                 EngineConfig(max_batched_tokens=max_batched_tokens,
                              max_slots=max_slots if decode_offload else 2,
                              block_size=block_size,
                              num_kv_blocks=ppi_blocks, prefill_only=True,
                              sched_policy=sched_policy,
                              prefix_cache=prefix_cache,
                              host_kv_blocks=host_kv_blocks,
                              executor=executor),
                 ppi_device, executor_factory("ppi"))
    cpi = Engine("cpi", cfg,
                 EngineConfig(max_batched_tokens=max_batched_tokens,
                              max_slots=max_slots, block_size=block_size,
                              num_kv_blocks=cpi_blocks,
                              decode_only=decode_only_cpi,
                              sched_policy=sched_policy,
                              prefix_cache=prefix_cache,
                              host_kv_blocks=host_kv_blocks,
                              executor=executor),
                 cpi_device, executor_factory("cpi"))
    return CronusSystem(ppi=ppi, cpi=cpi,
                        balancer=balancer if balancer is not None
                        else FixedBalancer(),
                        decode_offload=decode_offload)


def build_disaggregated(cfg, prefill_device, decode_device, *,
                        executor_factory: Callable, **kw) -> CronusSystem:
    """Disagg L-H: prefill_device=low / decode_device=high; H-L swapped."""
    return build_cronus(cfg, prefill_device, decode_device,
                        executor_factory=executor_factory,
                        balancer=FixedBalancer(), decode_only_cpi=True, **kw)
