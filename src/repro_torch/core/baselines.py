"""DP+chunked and PP+chunked baselines (paper §3.2-3.3, §5.1).

Disaggregated H-L / L-H live in cronus.py (they reuse the Cronus code with a
pinned partial length, exactly as the paper's evaluation does).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from repro_torch.cluster.router import RoundRobinRouter
from repro_torch.cluster.runtime import ClusterRuntime, WorkerEndpoint
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.request import Request
from repro_torch.serving.hardware import (DeviceModel, DeviceSpec, active_param_bytes,
                                    attn_flops, kv_bytes_per_token,
                                    matmul_flops_per_token, param_bytes,
                                    transfer_bytes)


# ---------------------------------------------------------------------------
# DP + chunked prefill
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DPSystem:
    """Weighted round-robin dispatch over independent engines.

    Paper §5.1: weight 3 for the A100, 1 for the A10/A30; waiting-queue caps
    3 and 1; chunk size 512 on the high-end engine, 256 on the low-end."""
    engines: List[Engine]
    weights: List[int]
    queue_caps: List[int]

    def endpoints(self) -> List[WorkerEndpoint]:
        """One worker endpoint per engine, with its queue cap."""
        return [WorkerEndpoint(e.name, e, queue_cap=cap)
                for e, cap in zip(self.engines, self.queue_caps)]

    def run(self, requests: List[Request], max_steps: int = 10_000_000):
        # ready_time (set by WorkerEndpoint.submit) keeps engines from
        # running future arrivals early, so eager weighted-RR dispatch into
        # the shared cluster loop matches the old private loop exactly
        """Replay ``requests`` through the weighted round-robin cluster."""
        runtime = ClusterRuntime(self.endpoints(),
                                 RoundRobinRouter(weights=self.weights))
        return runtime.run(requests, max_steps)


def build_dp(cfg, hi_device: DeviceModel, lo_device: DeviceModel, *,
             executor_factory: Callable, max_slots: int = 64,
             block_size: int = 16, sched_policy: str = "fcfs",
             prefix_cache: bool = False,
             num_kv_blocks: Optional[int] = None,
             host_kv_blocks: int = 0,
             executor: str = "null") -> DPSystem:
    """DP + chunked prefill: one engine per device, weighted 3:1."""
    hi = Engine("dp-hi", cfg,
                EngineConfig(max_batched_tokens=512, max_slots=max_slots,
                             block_size=block_size,
                             num_kv_blocks=(num_kv_blocks if num_kv_blocks
                                            is not None else
                                            max(hi_device.kv_block_budget(block_size), 64)),
                             sched_policy=sched_policy,
                             prefix_cache=prefix_cache,
                             host_kv_blocks=host_kv_blocks,
                             executor=executor),
                hi_device, executor_factory("hi"))
    lo = Engine("dp-lo", cfg,
                EngineConfig(max_batched_tokens=256, max_slots=max_slots,
                             block_size=block_size,
                             num_kv_blocks=(num_kv_blocks if num_kv_blocks
                                            is not None else
                                            max(lo_device.kv_block_budget(block_size), 64)),
                             sched_policy=sched_policy,
                             prefix_cache=prefix_cache,
                             host_kv_blocks=host_kv_blocks,
                             executor=executor),
                lo_device, executor_factory("lo"))
    return DPSystem(engines=[hi, lo], weights=[3, 1], queue_caps=[3, 1])


# ---------------------------------------------------------------------------
# PP + chunked prefill
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PipelineDeviceModel:
    """Two-stage heterogeneous pipeline: layers split by BF16 FLOPS (paper
    §5.1). vLLM-0.6.1-era PP executes a batch's stages synchronously (no
    microbatch overlap within one engine step), so an iteration costs the
    SUM of stage times plus the inter-stage activation transfer — incurred
    per chunk during prefill and per token during decode, the accumulated
    overhead of §3.3."""
    hi: DeviceSpec
    lo: DeviceSpec
    cfg: object

    @property
    def frac_hi(self) -> float:
        """Share of the layers on the high-end stage (by BF16 FLOPS)."""
        return self.hi.flops / (self.hi.flops + self.lo.flops)

    def _stage_time(self, spec: DeviceSpec, frac: float, flops: float,
                    bytes_: float) -> float:
        t_c = frac * flops / (spec.flops * spec.flops_eff)
        t_m = frac * bytes_ / (spec.hbm_bw * spec.bw_eff)
        return max(t_c, t_m) + spec.overhead

    def chunked_iter_time(self, prefill_tokens: int, prefill_ctx: int,
                          decode_ctx_sum: float, n_decode: int) -> float:
        """One mixed iteration: both stages in turn plus the activation hop."""
        new = prefill_tokens + n_decode
        f = matmul_flops_per_token(self.cfg) * new \
            + attn_flops(self.cfg, prefill_tokens,
                         prefill_ctx + prefill_tokens / 2.0) \
            + attn_flops(self.cfg, 1, decode_ctx_sum)
        by = active_param_bytes(self.cfg) \
            + kv_bytes_per_token(self.cfg) * (
                prefill_ctx + prefill_tokens + decode_ctx_sum + new)
        stage = (self._stage_time(self.hi, self.frac_hi, f, by)
                 + self._stage_time(self.lo, 1 - self.frac_hi, f, by))
        comm = max(new, 1) * self.cfg.d_model * 2.0 / self.hi.link_bw
        return stage + comm

    def decode_iter_time(self, decode_ctx_sum: float, n_decode: int) -> float:
        """A decode-only iteration."""
        return self.chunked_iter_time(0, 0, decode_ctx_sum, n_decode)

    def prefill_time(self, n_tokens: int, ctx_start: int = 0) -> float:
        """A prefill-only iteration of ``n_tokens``."""
        return self.chunked_iter_time(n_tokens, ctx_start, 0.0, 0)

    def transfer_time(self, n_tokens: int) -> float:
        """No KV handoff: both stages serve every request."""
        return 0.0

    def host_kv_time(self, n_tokens: int) -> float:
        # both stages share the hi host's PCIe attach for the modeled tier
        """Host-tier KV movement over the high-end stage's PCIe."""
        return transfer_bytes(self.cfg, n_tokens) / self.hi.pcie_bw

    def kv_block_budget(self, block_size: int, mem_frac: float = 0.9) -> int:
        """Each stage holds its fraction of layers' KV; capacity is the min
        over stages (paper §3.3: reduced effective batch size)."""
        per_tok = kv_bytes_per_token(self.cfg)
        if per_tok <= 0:
            return 1_000_000
        caps = []
        for spec, frac in ((self.hi, self.frac_hi), (self.lo, 1 - self.frac_hi)):
            free = spec.hbm_cap * mem_frac - frac * param_bytes(self.cfg)
            caps.append(free / (per_tok * frac * block_size))
        return max(int(min(caps)), 0)


@dataclasses.dataclass
class PPSystem:
    """PP + chunked prefill: one engine over the two-stage pipeline."""
    engine: Engine

    def run(self, requests: List[Request], max_steps: int = 10_000_000):
        # single unbounded endpoint: FCFS into the one fused-pipeline engine
        """Replay ``requests`` through the one pipeline engine."""
        runtime = ClusterRuntime(
            [WorkerEndpoint(self.engine.name, self.engine, queue_cap=None)],
            RoundRobinRouter())
        return runtime.run(requests, max_steps)


def build_pp(cfg, hi_spec: DeviceSpec, lo_spec: DeviceSpec, *,
             executor_factory: Callable, max_slots: int = 64,
             block_size: int = 16, sched_policy: str = "fcfs",
             prefix_cache: bool = False,
             num_kv_blocks: Optional[int] = None,
             host_kv_blocks: int = 0,
             executor: str = "null") -> PPSystem:
    """PP + chunked prefill over a two-stage heterogeneous pipeline."""
    device = PipelineDeviceModel(hi_spec, lo_spec, cfg)
    eng = Engine("pp", cfg,
                 EngineConfig(max_batched_tokens=512, max_slots=max_slots,
                              block_size=block_size,
                              num_kv_blocks=(num_kv_blocks if num_kv_blocks
                                             is not None else
                                             max(device.kv_block_budget(block_size), 64)),
                              sched_policy=sched_policy,
                              prefix_cache=prefix_cache,
                              host_kv_blocks=host_kv_blocks,
                              executor=executor),
                 device, executor_factory("pp"))
    return PPSystem(engine=eng)
