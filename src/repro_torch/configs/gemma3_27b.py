"""gemma3-27b [dense] — 5:1 local:global sliding-window pattern, 128k context.

[hf:google/gemma-3-1b-pt family scaled per assignment] 62 layers,
d_model=5376, 32 heads (GQA kv=16), d_ff=21504, vocab=262144.
Local layers: window=1024; every 6th layer is global. long_500k runs
natively (local layers bounded; global layers sequence-sharded decode).
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="gemma3-27b",
    arch_type="dense",
    n_layers=62,
    d_model=5_376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21_504,
    vocab_size=262_144,
    head_dim=128,
    qk_norm=True,               # gemma3 uses qk-norm
    window_size=1_024,          # native local window
    global_every=6,             # 5 local : 1 global
    rope_theta=1_000_000.0,
    citation="hf:google/gemma-3-1b-pt",
)

SMOKE_CONFIG = smoke_variant(CONFIG)
