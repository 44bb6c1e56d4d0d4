"""Serving systems: the Cronus pair, the disaggregated baselines, DP and PP.

The same scheduler/balancer/engine code drives ``NullExecutor`` (no tensor
compute, simulated clocks from the roofline device models) and the real
executors (:mod:`repro_torch.serving.api`). The clocks stay simulated on
real compute, as in the JAX package.
"""
from __future__ import annotations

from repro_torch.core.balancer import Balancer
from repro_torch.core.baselines import build_dp, build_pp
from repro_torch.core.cronus import build_cronus, build_disaggregated
from repro_torch.core.executor import NullExecutor
from repro_torch.core.predictor import profile_chunked, profile_prefill
from repro_torch.serving.hardware import DeviceModel, DeviceSpec

APPROACHES = ("cronus", "dp", "pp", "disagg_hl", "disagg_lh")


def _null_factory(role: str):
    return NullExecutor()


def build_system(approach: str, cfg, hi_spec: DeviceSpec, lo_spec: DeviceSpec,
                 *, max_slots: int = 256, block_size: int = 16,
                 max_batched_tokens: int = 512, executor_factory=None,
                 sched_policy: str = "fcfs", prefix_cache: bool = False,
                 num_kv_blocks=None, host_kv_blocks: int = 0,
                 executor: str = "null"):
    """Build one of the five approaches as a runnable system facade."""
    executor_factory = executor_factory or _null_factory
    hi = DeviceModel(hi_spec, cfg)
    lo = DeviceModel(lo_spec, cfg)
    kw = dict(executor_factory=executor_factory, max_slots=max_slots,
              block_size=block_size, sched_policy=sched_policy,
              prefix_cache=prefix_cache, num_kv_blocks=num_kv_blocks,
              host_kv_blocks=host_kv_blocks, executor=executor)
    if approach == "cronus":
        bal = Balancer(profile_prefill(lo), profile_chunked(hi))
        return build_cronus(cfg, lo, hi, balancer=bal,
                            max_batched_tokens=max_batched_tokens, **kw)
    if approach == "disagg_lh":   # prefill on low-end, decode on high-end
        return build_disaggregated(cfg, lo, hi,
                                   max_batched_tokens=max_batched_tokens, **kw)
    if approach == "disagg_hl":   # prefill on high-end, decode on low-end
        return build_disaggregated(cfg, hi, lo,
                                   max_batched_tokens=max_batched_tokens, **kw)
    if approach == "dp":
        return build_dp(cfg, hi, lo, **kw)
    if approach == "pp":
        return build_pp(cfg, hi_spec, lo_spec, **kw)
    raise KeyError(approach)

