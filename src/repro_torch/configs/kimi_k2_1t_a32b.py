"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8.

[arXiv:2501.kimi2] 61 layers, d_model=7168, 64 heads (GQA kv=8),
expert d_ff=2048, vocab=163840, 384 routed experts top-8 + 1 shared,
first layer dense (deepseek-v3-style).
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    n_layers=61,
    d_model=7_168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2_048,                 # per-expert ffn
    vocab_size=163_840,
    head_dim=112,               # 7168 / 64
    n_experts=384,
    n_shared_experts=1,
    top_k=8,
    moe_dense_layers=1,
    moe_dense_d_ff=18_432,
    swa_variant_window=4_096,   # SWA variant for long_500k only
    citation="arXiv:2501.kimi2",
)

SMOKE_CONFIG = smoke_variant(CONFIG)
