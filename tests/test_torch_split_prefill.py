"""The Cronus invariant on the port, mirroring ``tests/test_split_prefill
.py``: a partial prefill plus a chunked continuation over the same slot
cache gives the logits of a monolithic prefill, for every architecture
family (KV caches, MLA latents, SSM states, hybrid, cross-attention).

Smoke configs in fp32 on the CPU, weights drawn from a seeded
``torch.Generator``, 24 prompt tokens from a numpy seed (whisper: 16
encoder frames), split after 1, 11 and 23 tokens. Both runs compute in
fp32 over the same weights, so the logits agree within 1e-4 (the JAX
test allows 2e-2 for bf16-sized noise).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.api import build_model

ARCHS = ["llama3-8b", "mamba2-780m", "hymba-1.5b", "deepseek-v2-236b",
         "kimi-k2-1t-a32b", "gemma3-27b", "qwen3-32b", "whisper-base"]
N_TOKENS, N_FRAMES, S_KV = 24, 16, 64
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu", exact_moe=True,
                        generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, N_TOKENS)))
    enc_out = None
    if cfg.enc_dec:
        enc = torch.from_numpy(rng.standard_normal(
            (1, N_FRAMES, cfg.d_model)).astype(np.float32))
        with torch.no_grad():
            enc_out = model.encode(model.params, enc)
    return cfg, model, toks, enc_out


def _prefill(model, toks, enc_out, bounds):
    """Logits of the chunks ``toks[lo:hi]`` for consecutive ``bounds``,
    run in turn over one cache (the encoder output with the first)."""
    cache = (model.init_cache(1, S_KV, N_FRAMES) if enc_out is not None
             else model.init_cache(1, S_KV))
    parts = []
    with torch.no_grad():
        for lo, hi in zip(bounds, bounds[1:]):
            kw = {"enc_out": enc_out} if enc_out is not None and lo == 0 \
                else {}
            lg, cache, _ = model.forward(model.params, toks[:, lo:hi], cache,
                                         torch.full((1,), lo), **kw)
            parts.append(lg)
    return torch.cat(parts, dim=1)


@pytest.mark.parametrize("split", [1, 11, 23])
@pytest.mark.parametrize("arch", ARCHS)
def test_split_equals_full(arch, split):
    cfg, model, toks, enc_out = _setup(arch)
    want = _prefill(model, toks, enc_out, (0, N_TOKENS))
    got = _prefill(model, toks, enc_out, (0, split, N_TOKENS))
    assert torch.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
