"""llama3-8b — the paper's primary evaluation model (Table 2, Fig. 4).

[arXiv:2407.21783] 32 layers, d_model=4096, 32 heads (GQA kv=8),
d_ff=14336, vocab=128256.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="llama3-8b",
    arch_type="dense",
    n_layers=32,
    d_model=4_096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=128_256,
    head_dim=128,
    rope_theta=500_000.0,
    swa_variant_window=4_096,
    citation="arXiv:2407.21783",
)

SMOKE_CONFIG = smoke_variant(CONFIG)
