"""Serving systems: the Cronus pair, the disaggregated baselines, DP and
PP, and the paper-scale experiments over them.

The same scheduler/balancer/engine code drives ``NullExecutor`` (no tensor
compute, simulated clocks from the roofline device models) and the real
executors (:mod:`repro_torch.serving.api`). The clocks stay simulated on
real compute, as in the JAX package. On the null executor the helpers
below are a discrete-event simulation whose control flow is the
production code; they reproduce the shape of the paper's Table 2 (max
throughput), Fig. 4 (TTFT/TBT P99) and Table 3 (disaggregated load
imbalance).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.balancer import Balancer
from repro_torch.core.baselines import build_dp, build_pp
from repro_torch.core.cronus import build_cronus, build_disaggregated
from repro_torch.core.executor import NullExecutor
from repro_torch.core.predictor import profile_chunked, profile_prefill
from repro_torch.core.request import Request
from repro_torch.serving.hardware import DeviceModel, DeviceSpec
from repro_torch.serving.trace import Trace

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


def run_approach(approach: str, cfg, hi_spec, lo_spec,
                 requests: List[Request], **kw) -> Dict[str, float]:
    """Build an approach, replay a trace, return aggregate metrics."""
    system = build_system(approach, cfg, hi_spec, lo_spec, **kw)
    return system.run(Trace(requests).fresh())


def compare_all(cfg, hi_spec, lo_spec, requests,
                approaches=APPROACHES, **kw) -> Dict[str, Dict[str, float]]:
    """Metrics for every approach on the same (fresh) trace."""
    return {a: run_approach(a, cfg, hi_spec, lo_spec, requests, **kw)
            for a in approaches}


# ---------------------------------------------------------------------------
# Table 3: relative utilization of the disaggregated configurations
# ---------------------------------------------------------------------------

def max_prefill_throughput(device: DeviceModel, requests) -> float:
    """Requests/s if the instance did nothing but full prefills."""
    total = sum(device.prefill_time(r.input_len) for r in requests)
    return len(requests) / total


def max_decode_throughput(device: DeviceModel, requests, *,
                          max_slots: int = 256, block_size: int = 16) -> float:
    """Requests/s if the instance did nothing but decode (prompts appear
    pre-filled): bounded by memory (batch) and decode iteration time."""
    budget_tokens = device.kv_block_budget(block_size) * block_size
    avg_ctx = sum(r.input_len + r.output_len / 2 for r in requests) / len(requests)
    avg_out = sum(r.output_len for r in requests) / len(requests)
    batch = max(min(max_slots, int(budget_tokens / max(avg_ctx, 1))), 1)
    t_iter = device.decode_iter_time(batch * avg_ctx, batch)
    # one iteration decodes `batch` tokens; a request needs avg_out tokens
    return batch / (avg_out * t_iter)


def utilization_table(cfg, hi_spec, lo_spec, requests) -> Dict[str, Dict[str, float]]:
    """Paper Table 3: system throughput / standalone instance throughput."""
    hi, lo = DeviceModel(hi_spec, cfg), DeviceModel(lo_spec, cfg)
    out = {}
    for name, pre_dev, dec_dev in (("disagg_hl", hi, lo), ("disagg_lh", lo, hi)):
        res = run_approach(name, cfg, hi_spec, lo_spec, requests)
        tput = res["throughput"]
        out[name] = {
            "prefill_util": tput / max_prefill_throughput(pre_dev, requests),
            "decode_util": tput / max_decode_throughput(dec_dev, requests),
            "throughput": tput,
        }
    return out
