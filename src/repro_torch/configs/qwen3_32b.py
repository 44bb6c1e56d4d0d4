"""qwen3-32b [dense] — qk_norm, GQA kv=8.

[hf:Qwen/Qwen3-8B family scaled per assignment] 64 layers, d_model=5120,
64 heads (GQA kv=8), d_ff=25600, vocab=151936, per-head RMSNorm on q/k.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="qwen3-32b",
    arch_type="dense",
    n_layers=64,
    d_model=5_120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25_600,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    swa_variant_window=4_096,   # SWA variant for long_500k only
    citation="hf:Qwen/Qwen3-8B",
)

SMOKE_CONFIG = smoke_variant(CONFIG)
