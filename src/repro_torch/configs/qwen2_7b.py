"""qwen2-7b — the paper's second evaluation model (Table 2, Fig. 4).

[arXiv:2407.10671] 28 layers, d_model=3584, 28 heads (GQA kv=4),
d_ff=18944, vocab=152064.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="qwen2-7b",
    arch_type="dense",
    n_layers=28,
    d_model=3_584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18_944,
    vocab_size=152_064,
    head_dim=128,
    rope_theta=1_000_000.0,
    swa_variant_window=4_096,
    citation="arXiv:2407.10671",
)

SMOKE_CONFIG = smoke_variant(CONFIG)
