"""Device specs + roofline iteration-time model for heterogeneous serving.

The paper profiles real GPUs and fits linear predictors (§4.4). Without GPUs
in this container, iteration times come from a roofline cost model over
published device specs — the same linearity in (prefill context, decode
context) emerges, so the paper's regression machinery fits these times with
R² comparable to the paper's (validated in bench_fig3_predictor_fit).

TPU entries map the paper's heterogeneity onto pods of different
generations (DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Published capability numbers for one accelerator type."""

    name: str
    flops: float          # peak bf16 FLOP/s
    hbm_bw: float         # bytes/s
    hbm_cap: float        # bytes
    link_bw: float        # bytes/s to the peer device (IB / ICI / DCN)
    flops_eff: float = 0.55   # achievable fraction of peak in mixed batches
    bw_eff: float = 0.75
    overhead: float = 3.0e-3  # fixed per-iteration launch/schedule overhead (s)
    # device <-> host-DRAM bandwidth (PCIe 4.0 x16 ~ 32 GB/s for the GPUs;
    # TPU hosts see similar PCIe attach) — the cost the host-memory KV tier
    # pays on demote/promote
    pcie_bw: float = 32e9


# published specs; link = IB 100 Gb/s for GPUs, ICI/DCN for TPUs
A100 = DeviceSpec("A100", 312e12, 2039e9, 80e9, 12.5e9)
A30 = DeviceSpec("A30", 165e12, 933e9, 24e9, 12.5e9)
A10 = DeviceSpec("A10", 125e12, 600e9, 24e9, 12.5e9)
V5E = DeviceSpec("TPUv5e", 197e12, 819e9, 16e9, 50e9)
V4 = DeviceSpec("TPUv4", 275e12, 1228e9, 32e9, 50e9)

DEVICES = {d.name: d for d in (A100, A30, A10, V5E, V4)}


# ---------------------------------------------------------------------------
# per-model cost primitives
# ---------------------------------------------------------------------------

def kv_bytes_per_token(cfg: ModelConfig) -> float:
    """KV-cache bytes appended per token (bf16)."""
    if cfg.arch_type == "ssm":
        return 0.0  # constant state, not per-token
    if cfg.mla_kv_lora_rank:
        per_layer = cfg.mla_kv_lora_rank + cfg.mla_rope_head_dim
    else:
        per_layer = 2 * cfg.n_kv_heads * cfg.head_dim
    return 2.0 * cfg.n_layers * per_layer


def ssm_state_bytes(cfg: ModelConfig) -> float:
    """Recurrent-state bytes per request (fp32 state + conv cache)."""
    if not cfg.ssm_state:
        return 0.0
    d_inner = cfg.ssm_expand * cfg.d_model
    n_h = cfg.ssm_n_heads or max(1, d_inner // cfg.ssm_head_dim)
    p = d_inner // n_h
    state = 4.0 * n_h * p * cfg.ssm_state
    conv = 2.0 * (cfg.ssm_conv_width - 1) * (d_inner + 2 * cfg.ssm_state)
    return cfg.n_layers * (state + conv)


def transfer_bytes(cfg: ModelConfig, n_tokens: int) -> float:
    """Bytes shipped PPI->CPI for a partial prefill of n_tokens."""
    return kv_bytes_per_token(cfg) * n_tokens + ssm_state_bytes(cfg)


def param_bytes(cfg: ModelConfig) -> float:
    """Weight bytes at bf16."""
    return 2.0 * cfg.param_count()


def active_param_bytes(cfg: ModelConfig) -> float:
    """Bytes of weights touched per token (MoE: active experts only)."""
    return 2.0 * cfg.active_param_count()


def matmul_flops_per_token(cfg: ModelConfig) -> float:
    """Dense matmul FLOPs per token (2 * active params)."""
    return 2.0 * cfg.active_param_count()


def attn_flops(cfg: ModelConfig, new_tokens: float, avg_ctx: float) -> float:
    """score + value matmuls over context (per full forward of new_tokens)."""
    if cfg.arch_type == "ssm":
        # SSD intra-chunk matmuls ~ O(tokens * chunk * (N + P))
        d_inner = cfg.ssm_expand * cfg.d_model
        return 4.0 * cfg.n_layers * new_tokens * cfg.ssm_chunk * (
            cfg.ssm_state + d_inner / max(cfg.ssm_n_heads, 1))
    hd = cfg.head_dim if not cfg.mla_kv_lora_rank else (
        cfg.mla_nope_head_dim + cfg.mla_rope_head_dim)
    return 4.0 * cfg.n_layers * cfg.n_heads * hd * new_tokens * avg_ctx


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Roofline iteration-time model for one model on one device."""
    spec: DeviceSpec
    cfg: ModelConfig

    def _time(self, flops: float, bytes_: float) -> float:
        t_c = flops / (self.spec.flops * self.spec.flops_eff)
        t_m = bytes_ / (self.spec.hbm_bw * self.spec.bw_eff)
        return max(t_c, t_m) + self.spec.overhead

    def prefill_time(self, n_tokens: int, ctx_start: int = 0) -> float:
        """Full/partial prefill of n_tokens starting from ctx_start."""
        avg_ctx = ctx_start + n_tokens / 2.0
        f = matmul_flops_per_token(self.cfg) * n_tokens \
            + attn_flops(self.cfg, n_tokens, avg_ctx)
        by = active_param_bytes(self.cfg) \
            + kv_bytes_per_token(self.cfg) * (ctx_start + n_tokens)
        return self._time(f, by)

    def chunked_iter_time(self, prefill_tokens: int, prefill_ctx: int,
                          decode_ctx_sum: float, n_decode: int) -> float:
        """One CPI iteration: a prefill chunk + piggybacked decodes (Eq. 3's
        ground truth)."""
        new = prefill_tokens + n_decode
        f = matmul_flops_per_token(self.cfg) * new \
            + attn_flops(self.cfg, prefill_tokens,
                         prefill_ctx + prefill_tokens / 2.0) \
            + attn_flops(self.cfg, 1, decode_ctx_sum)
        by = active_param_bytes(self.cfg) \
            + kv_bytes_per_token(self.cfg) * (
                prefill_ctx + prefill_tokens + decode_ctx_sum + new)
        return self._time(f, by)

    def decode_iter_time(self, decode_ctx_sum: float, n_decode: int) -> float:
        """Seconds for one decode-only iteration."""
        return self.chunked_iter_time(0, 0, decode_ctx_sum, n_decode)

    def transfer_time(self, n_tokens: int) -> float:
        """Seconds to ship n_tokens of KV across the inter-device link."""
        return transfer_bytes(self.cfg, n_tokens) / self.spec.link_bw

    def host_kv_time(self, n_tokens: int) -> float:
        """Seconds to move n_tokens of KV across PCIe (host-memory tier
        demotions/promotions — charged by the engine, overlapped with
        compute like link transfers)."""
        return transfer_bytes(self.cfg, n_tokens) / self.spec.pcie_bw

    # capacity: how many KV blocks fit beside the weights
    def kv_block_budget(self, block_size: int, mem_frac: float = 0.9) -> int:
        """KV blocks that fit in HBM beside the weights."""
        free = self.spec.hbm_cap * mem_frac - param_bytes(self.cfg)
        per_block = kv_bytes_per_token(self.cfg) * block_size
        if per_block <= 0:
            return 1_000_000  # SSM: constant state, effectively unbounded
        return max(int(free / per_block), 0)
