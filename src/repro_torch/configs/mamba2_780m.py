"""mamba2-780m [ssm] — attention-free SSD (state-space duality).

[arXiv:2405.21060] 48 layers, d_model=1536, vocab=50280, ssm_state=128,
expand=2 => d_inner=3072, head_dim=64 => 48 ssm heads.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    n_layers=48,
    d_model=1_536,
    n_heads=1,                  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,                     # no MLP block (mamba2 blocks only)
    vocab_size=50_280,
    head_dim=64,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_n_heads=48,             # d_inner 3072 / 64
    ssm_chunk=64,
    tie_embeddings=True,
    citation="arXiv:2405.21060",
)

SMOKE_CONFIG = smoke_variant(CONFIG)
