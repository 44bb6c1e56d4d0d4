"""whisper-base [audio] — enc-dec transformer backbone, conv frontend stubbed.

[arXiv:2212.04356] Whisper base: 6 enc + 6 dec layers, d_model=512, 8 heads,
d_ff=2048, vocab=51865. Audio frontend (mel + conv) is a stub: input_specs
provides precomputed frame embeddings (1500 frames for 30 s audio).
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    n_layers=6,                 # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,               # GQA kv=8 (== MHA here)
    d_ff=2048,
    vocab_size=51_865,
    enc_dec=True,
    n_enc_layers=6,
    enc_seq_len=1_500,
    embeddings_input=True,      # encoder consumes precomputed frame embeddings
    rope_theta=10_000.0,        # (whisper uses learned abs pos; we use rope — noted in DESIGN.md)
    swa_variant_window=4_096,   # SWA variant enables long_500k decode (synthetic stress)
    citation="arXiv:2212.04356",
)

SMOKE_CONFIG = smoke_variant(CONFIG)
