"""MLA (DeepSeek-V2's latent attention) of the port against the JAX
package's.

On the CPU in fp32 with TF32 off, at deepseek-v2's smoke config, with and
without the query LoRA (``mla_q_lora_rank=0``), from numpy inputs and
JAX-drawn weights bridged over (norm weights moved off zero by numpy
draws):

  * ``mla_attention_block``: a chunked prefill with a padded query, then
    decode steps, over a latent cache whose ``kv_pos`` has -1 holes;
    outputs within 1e-4 and the ``ckv``/``kpe`` caches written in place
    equal to JAX's new caches;
  * ``DecoderModel.forward`` (a dense first layer, then MoE, all MLA) on a
    prefill chunk and a decode step: logits within 1e-4, ``aux`` within
    1e-5, and both cache subtrees equal to JAX's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import build_model
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import NORM_KEYS, DecoderModel

ARCH = "deepseek-v2-236b"
# one compile per shape rather than one per eager op
JAX_MLA = jax.jit(jattn.mla_attention_block, static_argnums=(1, 7))
Q_LORA = {"q-lora": {}, "no-q-lora": dict(mla_q_lora_rank=0)}


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _perturb_norms(tree, rng):
    """Norm weights (zeros from init) moved to small numpy draws."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_norms(v, rng)
        elif k in NORM_KEYS:
            out[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _configs(variant):
    over = Q_LORA[variant]
    return (dataclasses.replace(get_config(ARCH, smoke=True), **over),
            dataclasses.replace(jax_get_config(ARCH, smoke=True), **over))


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("variant", list(Q_LORA))
def test_mla_attention_block_matches_jax(variant):
    """8 queries at cache lengths 10 and 13 (the second row's last two
    are padding) over a cache of 40 positions with holes, then three
    decode steps."""
    cfg, jcfg = _configs(variant)
    rng = np.random.default_rng(7)
    tree = _perturb_norms(jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.PRNGKey(2), jcfg)), rng)
    assert ("w_uq" in tree) == bool(cfg.mla_q_lora_rank)
    p = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    b, s_kv = 2, 40
    r_kv, hd_r = cfg.mla_kv_lora_rank, cfg.mla_rope_head_dim
    ckv = rng.standard_normal((b, s_kv, r_kv)).astype(np.float32)
    kpe = rng.standard_normal((b, s_kv, hd_r)).astype(np.float32)
    lens = np.asarray([10, 13], np.int32)
    kv_pos = np.full((b, s_kv), -1, np.int32)
    for i in range(b):
        kv_pos[i, :lens[i]] = np.arange(lens[i])
    kv_pos[rng.random((b, s_kv)) < 0.25] = -1          # holes
    jcache = {"ckv": jnp.asarray(ckv), "kpe": jnp.asarray(kpe)}
    cache = {"ckv": torch.from_numpy(ckv.copy()),
             "kpe": torch.from_numpy(kpe.copy())}

    sq = 8
    for step in range(4):
        x = rng.standard_normal((b, sq, cfg.d_model)).astype(np.float32)
        positions = lens[:, None] + np.arange(sq, dtype=np.int32)[None]
        if step == 0:
            positions[1, -2:] = -1
        idx = np.array(jattn.write_indices(jnp.asarray(lens), sq, s_kv))
        live = positions >= 0
        for i in range(b):
            kv_pos[i, idx[i][live[i]]] = positions[i][live[i]]
        want, jcache = JAX_MLA(
            tree, jcfg, jnp.asarray(x), jnp.asarray(positions),
            jnp.asarray(kv_pos), jnp.asarray(idx), jcache, 0)
        with torch.no_grad():
            got, cache = tattn.mla_attention_block(
                p, cfg, torch.from_numpy(x), torch.from_numpy(positions),
                torch.from_numpy(kv_pos), torch.from_numpy(idx), cache, 0)
        _close(got.numpy()[live], np.asarray(want)[live])
        for key in ("ckv", "kpe"):
            _close(cache[key], jcache[key], 1e-5)
        lens = lens + live.sum(1).astype(np.int32)
        sq = 1                   # decode steps after the prefill chunk


@functools.lru_cache(maxsize=None)
def _models(variant):
    cfg, jcfg = _configs(variant)
    jmodel = build_model(jcfg, exact_moe=True)
    tree = _perturb_norms(jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0))), np.random.default_rng(1))
    model = DecoderModel(cfg, params_from_numpy(tree, cfg, device="cpu"),
                         device="cpu", exact_moe=True)
    fwd = jax.jit(lambda *a: jmodel.forward(*a[:4], positions=a[4],
                                            kv_positions=a[5]))
    return cfg, fwd, jmodel, jax.tree.map(jnp.asarray, tree), model


@pytest.mark.parametrize("variant", list(Q_LORA))
def test_deepseek_forward_matches_jax(variant):
    """A 16-token prefill chunk on two rows (one padded), then a decode
    step: logits within 1e-4, aux within 1e-5, both caches (the dense
    first layer's and the MoE stack's latents) equal to JAX's."""
    cfg, jfwd, jmodel, jparams, model = _models(variant)
    rng = np.random.default_rng(4)
    b, c, s_kv = 2, 16, 40
    toks = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
    positions = np.tile(np.arange(c, dtype=np.int32), (b, 1))
    positions[1, 11:] = -1
    kv_pos = np.full((b, s_kv), -1, np.int32)
    kv_pos[0, :c] = np.arange(c)
    kv_pos[1, :11] = np.arange(11)
    lens = np.zeros((b,), np.int32)
    jcache, cache = jmodel.init_cache(b, s_kv), model.init_cache(b, s_kv)
    assert set(cache) == set(jcache) == {"pos", "dense", "stack"}
    for step in range(2):
        jl, jcache, jaux = jfwd(
            jparams, jnp.asarray(toks), jcache, jnp.asarray(lens),
            jnp.asarray(positions), jnp.asarray(kv_pos))
        with torch.no_grad():
            tl, cache, aux = model.forward(
                model.params, torch.from_numpy(toks), cache,
                torch.from_numpy(lens), positions=torch.from_numpy(positions),
                kv_positions=torch.from_numpy(kv_pos))
        live = positions >= 0
        _close(tl.numpy()[live], np.asarray(jl)[live])
        _close(float(aux), float(jaux), 1e-5)
        assert float(aux) > 0
        for group in ("dense", "stack"):
            for key in ("ckv", "kpe"):
                _close(cache[group][key], jcache[group][key], 1e-5)
        if step == 0:            # then one decode step from 16 and 11
            lens = np.asarray([c, 11], np.int32)
            toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
            positions = lens[:, None].copy()
            kv_pos[0, c], kv_pos[1, 11] = c, 11
