"""deepseek-coder-33b [dense] — llama-arch GQA.

[arXiv:2401.14196] 62 layers, d_model=7168, 56 heads (GQA kv=8),
d_ff=19200, vocab=32256.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    n_layers=62,
    d_model=7_168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19_200,
    vocab_size=32_256,
    head_dim=128,
    swa_variant_window=4_096,   # SWA variant for long_500k only
    citation="arXiv:2401.14196",
)

SMOKE_CONFIG = smoke_variant(CONFIG)
