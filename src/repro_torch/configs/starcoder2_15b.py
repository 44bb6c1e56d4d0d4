"""starcoder2-15b [dense] — GQA kv=4, RoPE.

[arXiv:2402.19173] 40 layers, d_model=6144, 48 heads (GQA kv=4),
d_ff=24576, vocab=49152.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="starcoder2-15b",
    arch_type="dense",
    n_layers=40,
    d_model=6_144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24_576,
    vocab_size=49_152,
    head_dim=128,
    rope_theta=100_000.0,
    swa_variant_window=4_096,   # SWA variant for long_500k only
    citation="arXiv:2402.19173",
)

SMOKE_CONFIG = smoke_variant(CONFIG)
