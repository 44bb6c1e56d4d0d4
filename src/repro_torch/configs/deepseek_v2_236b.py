"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6.

[arXiv:2405.04434] 60 layers, d_model=5120, 128 heads, expert d_ff=1536,
vocab=102400. MLA: kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
nope_head_dim=128, v_head_dim=128. First layer dense (d_ff=12288).
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60,
    d_model=5_120,
    n_heads=128,
    n_kv_heads=128,             # MLA: effectively MHA over decompressed latents
    d_ff=1_536,                 # per-expert ffn
    vocab_size=102_400,
    head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    moe_dense_layers=1,
    moe_dense_d_ff=12_288,
    mla_kv_lora_rank=512,
    mla_q_lora_rank=1_536,
    mla_rope_head_dim=64,
    mla_nope_head_dim=128,
    mla_v_head_dim=128,
    swa_variant_window=4_096,   # SWA variant for long_500k only
    citation="arXiv:2405.04434",
)

SMOKE_CONFIG = smoke_variant(CONFIG)
