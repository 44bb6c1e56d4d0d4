"""Config system: model architecture configs, input shapes, registry.

Every assigned architecture gets one ``<id>.py`` module that exports
``CONFIG`` (full-size, exercised only via the dry-run) and
``SMOKE_CONFIG`` (reduced: <=2 layers, d_model<=512, <=4 experts; runs on CPU).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description covering all assigned families."""

    name: str
    arch_type: str                      # one of ARCH_TYPES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // n_heads
    citation: str = ""

    # --- attention flavour ---
    qk_norm: bool = False               # qwen3-style per-head RMSNorm on q,k
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) dims
    # sliding window: per-layer pattern. window_size=0 -> full attention.
    window_size: int = 0
    # every `global_every`-th layer is global (gemma3 5:1 => 6)
    global_every: int = 0
    # SWA *variant* window, applied only for long-context decode (long_500k)
    # on otherwise-full-attention archs (task-sanctioned sub-quadratic variant).
    swa_variant_window: int = 0
    # MLA (deepseek-v2): latent KV compression
    mla_kv_lora_rank: int = 0
    mla_q_lora_rank: int = 0
    mla_rope_head_dim: int = 64
    mla_nope_head_dim: int = 128
    mla_v_head_dim: int = 128

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # dense d_ff used for first `moe_dense_layers` layers (deepseek-style)
    moe_dense_layers: int = 0
    moe_dense_d_ff: int = 0

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_n_heads: int = 0                # mamba2 heads (d_inner // head_dim)
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64                 # SSD chunk length
    ssm_conv_width: int = 4

    # --- hybrid (hymba): parallel attn + ssm heads in the same layer ---
    hybrid: bool = False

    # --- encoder-decoder (whisper) ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq_len: int = 0                # encoder context (audio frames)

    # --- modality frontend stub (audio/vlm): inputs are embeddings ---
    embeddings_input: bool = False

    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.arch_type in ARCH_TYPES, self.arch_type

    # ----- derived quantities -------------------------------------------
    @property
    def is_moe(self) -> bool:
        """True for mixture-of-experts configs."""
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        """True for pure SSM configs."""
        return self.arch_type == "ssm"

    def layer_window(self, layer_idx: int) -> int:
        """Sliding-window size for a layer (0 = full attention)."""
        if self.window_size == 0:
            return 0
        if self.global_every and (layer_idx + 1) % self.global_every == 0:
            return 0  # global layer
        return self.window_size

    # ----- parameter counts (for roofline MODEL_FLOPS = 6 N D) ----------
    def param_count(self) -> int:
        """Total parameter count."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Parameters active per token (routed experts counted by top-k)."""
        return _param_count(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    if cfg.mla_kv_lora_rank:
        r_kv, r_q = cfg.mla_kv_lora_rank, cfg.mla_q_lora_rank or cfg.d_model
        hd_n, hd_r, hd_v = cfg.mla_nope_head_dim, cfg.mla_rope_head_dim, cfg.mla_v_head_dim
        n = cfg.n_heads
        p = d * (r_kv + hd_r)                       # kv down-proj (+ rope k)
        p += r_kv * n * (hd_n + hd_v)               # kv up-proj
        if cfg.mla_q_lora_rank:
            p += d * r_q + r_q * n * (hd_n + hd_r)
        else:
            p += d * n * (hd_n + hd_r)
        p += n * hd_v * d                           # o proj
        return p
    hd = cfg.head_dim
    return d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d


def _mlp_params(d: int, d_ff: int) -> int:
    return 3 * d * d_ff  # SwiGLU: gate, up, down


def _ssm_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    n_h = cfg.ssm_n_heads or max(1, d_inner // cfg.ssm_head_dim)
    p = d * (2 * d_inner + 2 * cfg.ssm_state + n_h)   # in_proj (x,z,B,C,dt)
    p += d_inner * cfg.ssm_conv_width                 # conv1d (depthwise)
    p += 2 * n_h                                      # A_log, D
    p += d_inner * d                                  # out_proj
    return p


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if cfg.embeddings_input:
        emb = cfg.vocab_size * d  # output head only; input is stub embeddings
    per_layer = 0
    total = emb
    n_layers = cfg.n_layers
    for i in range(n_layers):
        layer = 0
        if cfg.arch_type == "ssm":
            layer += _ssm_params(cfg)
        elif cfg.hybrid:
            layer += _attn_params(cfg) + _ssm_params(cfg) + _mlp_params(d, cfg.d_ff)
        else:
            layer += _attn_params(cfg)
            if cfg.is_moe and i >= cfg.moe_dense_layers:
                n_routed = cfg.top_k if active_only else cfg.n_experts
                layer += n_routed * _mlp_params(d, cfg.d_ff)
                layer += cfg.n_shared_experts * _mlp_params(d, cfg.d_ff)
            else:
                ff = cfg.moe_dense_d_ff or cfg.d_ff
                layer += _mlp_params(d, ff)
        total += layer
    if cfg.enc_dec:
        # encoder layers: attn + mlp; decoder already counted; cross-attn add
        enc = cfg.n_enc_layers * (_attn_params(cfg) + _mlp_params(d, cfg.d_ff))
        cross = cfg.n_layers * _attn_params(cfg)
        total += enc + cross
    return total


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned (sequence length, global batch, kind) input shape."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# The port serves one architecture so far; the JAX package's registry has
# the others, which come over with the model families that need them.
ARCH_IDS = (
    "llama3-8b",
)


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    """Full (or ``smoke``) config of a registered architecture; KeyError else."""
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def get_shape(shape_name: str) -> InputShape:
    """One of the assigned input shapes by name."""
    return INPUT_SHAPES[shape_name]


def smoke_variant(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced variant of the same family: <=2 layers, d_model<=512, <=4 experts."""
    small = dict(
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 2,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=64,
        # fp32 for CPU functional tests: bf16 ULP noise across batch shapes
        # flips greedy near-ties, breaking token-equality oracles
        dtype="float32",
    )
    if cfg.is_moe:
        small.update(n_experts=4, top_k=2, n_shared_experts=min(cfg.n_shared_experts, 1),
                     moe_dense_layers=min(cfg.moe_dense_layers, 1),
                     moe_dense_d_ff=512 if cfg.moe_dense_d_ff else 0)
    if cfg.mla_kv_lora_rank:
        small.update(mla_kv_lora_rank=32, mla_q_lora_rank=(64 if cfg.mla_q_lora_rank else 0),
                     mla_rope_head_dim=32, mla_nope_head_dim=32, mla_v_head_dim=32)
    if cfg.ssm_state:
        small.update(ssm_state=16, ssm_n_heads=8, ssm_head_dim=32, ssm_chunk=16)
    if cfg.window_size:
        small.update(window_size=64, global_every=cfg.global_every and 2)
    if cfg.mrope_sections:
        small.update(mrope_sections=(16, 8, 8))  # sums to head_dim(64)//2
    if cfg.enc_dec:
        small.update(n_enc_layers=2, enc_seq_len=64)
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)
