"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution; ViT frontend stubbed.

[arXiv:2409.12191] 80 layers, d_model=8192, 64 heads (GQA kv=8),
d_ff=29568, vocab=152064. M-RoPE sections (t, h, w) = (16, 24, 24) over
head_dim=128 (pairs). Vision encoder + projector are a stub:
input_specs provides precomputed patch embeddings interleaved with text.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    n_layers=80,
    d_model=8_192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29_568,
    vocab_size=152_064,
    head_dim=128,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    embeddings_input=True,      # mixed text-token + patch-embedding input
    swa_variant_window=4_096,   # SWA variant for long_500k only
    citation="arXiv:2409.12191",
)

SMOKE_CONFIG = smoke_variant(CONFIG)
