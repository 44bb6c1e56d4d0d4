"""hymba-1.5b [hybrid] — parallel attention + mamba heads in every layer.

[arXiv:2411.13676] 32 layers, d_model=1600, 25 heads (GQA kv=5),
d_ff=5504, vocab=32001, ssm_state=16. Attention heads use a sliding
window (global on a few layers); SSM branch is mamba-style. long_500k
runs natively (constant SSM state + window-bounded attention).
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    n_layers=32,
    d_model=1_600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5_504,
    vocab_size=32_001,
    head_dim=64,                # 1600 / 25
    hybrid=True,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_n_heads=50,             # d_inner 3200 / 64
    ssm_chunk=64,
    window_size=1_024,          # sliding-window attention branch
    global_every=16,            # a few global layers
    citation="arXiv:2411.13676",
)

SMOKE_CONFIG = smoke_variant(CONFIG)
