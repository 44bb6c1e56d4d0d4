"""The port's layers and weight bridge against the JAX package's.

Inputs are drawn with numpy and fed to both. Tolerances: 1e-6 in fp32
(elementwise work and one short reduction in each framework), 2e-2 in
bf16 (one bf16 rounding of values of magnitude up to ~4), 1e-5 where a
d=256 matrix product sums in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model
from repro.models import layers as jax_layers
from repro.models import rope as jax_rope
from repro_torch.configs import get_config
from repro_torch.models import bridge, layers, rope
from repro_torch.models.transformer import DecoderModel, init_params

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": 1e-6, "bfloat16": 2e-2}


def _pair(a, dtype="float32"):
    return jnp.asarray(a, JAX_DT[dtype]), torch.from_numpy(a).to(
        TORCH_DT[dtype])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    """(1 + w) scaling in fp32, cast back to the input dtype."""
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.standard_normal((2, 5, 64), np.float32) * 3, dtype)
    w = rng.standard_normal(64).astype(np.float32) * 0.1
    got = layers.rmsnorm(tx, torch.from_numpy(w), 1e-5)
    assert got.dtype == TORCH_DT[dtype]
    _close(got, jax_layers.rmsnorm(jx, jnp.asarray(w), 1e-5),
           max(TOL[dtype], 1e-5))


def test_swiglu_matches_jax():
    """silu(x Wg) * (x Wu) Wd with [in, out] weights."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 32), np.float32)
    wg, wu = (rng.standard_normal((32, 48), np.float32) * 0.2
              for _ in range(2))
    wd = rng.standard_normal((48, 32), np.float32) * 0.2
    got = layers.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    want = jax_layers.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope_matches_jax(dtype, theta):
    """Rotate-half on split halves, positions including large offsets."""
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.standard_normal((2, 6, 4, 64), np.float32), dtype)
    pos = np.stack([np.arange(6), 2040 + np.arange(6)]).astype(np.int32)
    got = rope.apply_rope(tx, torch.from_numpy(pos), theta)
    assert got.dtype == TORCH_DT[dtype]
    _close(got, jax_rope.apply_rope(jx, jnp.asarray(pos), theta),
           max(TOL[dtype], 2e-5))


def test_apply_mrope_and_position_encode_match_jax():
    """M-RoPE with distinct (t, h, w) positions, and the dispatcher."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 5, 2, 64), np.float32)
    pos3 = rng.integers(0, 50, (1, 5, 3)).astype(np.int32)
    got = rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                           (16, 8, 8), 1e6)
    want = jax_rope.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                (16, 8, 8), 1e6)
    _close(got, want, 2e-5)
    cfg, jcfg = get_config("llama3-8b", smoke=True), \
        jax_get_config("llama3-8b", smoke=True)
    pos = np.arange(5, dtype=np.int32)[None]
    _close(rope.position_encode(torch.from_numpy(x), torch.from_numpy(pos),
                                cfg),
           jax_rope.position_encode(jnp.asarray(x), jnp.asarray(pos), jcfg),
           2e-5)


def test_dense_init_is_truncated_fan_in():
    """N(0, 1) cut at +-2 times fan_in ** -0.5 (or the given scale),
    stored in the requested dtype, reproducible from the generator."""
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init((256, 512), generator=gen)
    assert w.dtype == torch.float32 and w.shape == (256, 512)
    assert w.abs().max() <= 2 * 256 ** -0.5 + 1e-7
    # std of N(0,1) truncated at +-2 is 0.8796
    assert abs(w.std().item() / 256 ** -0.5 - 0.8796) < 0.01
    e = layers.dense_init((1000, 64), generator=gen, scale=0.02,
                          dtype=torch.bfloat16)
    assert e.dtype == torch.bfloat16
    assert e.float().abs().max() <= 0.04 + 1e-3
    again = layers.dense_init((256, 512),
                              generator=torch.Generator().manual_seed(0))
    assert torch.equal(w, again)


@pytest.fixture(scope="module")
def jax_tree():
    jcfg = jax_get_config("llama3-8b", smoke=True)
    params = build_model(jcfg, exact_moe=True).init_params(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_bridge_shapes_and_dtypes(jax_tree, dtype):
    """The JAX pytree's layout is kept: stacked [L, ...] leaves, [in, out]
    matrices; weights in the model dtype, norm weights in fp32."""
    cfg = get_config("llama3-8b", smoke=True)
    p = bridge.params_from_numpy(jax_tree, cfg, device="cpu", dtype=dtype)
    want_dt = dtype or torch.float32
    flat_t = {k: v for k, v in _flatten(p)}
    flat_j = {k: v for k, v in _flatten(jax_tree)}
    assert set(flat_t) == set(flat_j)
    for key, t in flat_t.items():
        assert tuple(t.shape) == flat_j[key].shape, key
        norm = key[-1] in ("ln1", "ln2", "final_norm")
        assert t.dtype == (torch.float32 if norm else want_dt), key
        np.testing.assert_allclose(
            t.float().numpy(), flat_j[key],
            atol=0 if want_dt == torch.float32 or norm else 1e-2)
    L, d = cfg.n_layers, cfg.d_model
    assert p["layers"]["attn"]["wq"].shape == (L, d,
                                               cfg.n_heads * cfg.head_dim)
    assert p["layers"]["mlp"]["w_down"].shape == (L, cfg.d_ff, d)
    model = DecoderModel(cfg, p, device="cpu")
    assert model.n_stack == L and model._stack_kind() == "mlp"
    assert not model.is_mla and model.n_dense == 0
    assert model.params["embed"] is model.tree.embed


def test_bridge_refuses_a_wrong_tree(jax_tree):
    cfg = get_config("llama3-8b", smoke=True)
    bad = dict(jax_tree)
    bad.pop("final_norm")
    with pytest.raises(ValueError, match="keys"):
        bridge.params_from_numpy(bad, cfg, device="cpu")
    bad = dict(jax_tree, embed=jax_tree["embed"][:10])
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_numpy(bad, cfg, device="cpu")


def test_init_params_matches_the_bridge_layout(jax_tree):
    """Fresh weights drawn from a generator have the bridged layout."""
    cfg = get_config("llama3-8b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    fresh = dict(_flatten(init_params(cfg, generator=gen, device="cpu")))
    bridged = dict(_flatten(bridge.params_from_numpy(jax_tree, cfg,
                                                     device="cpu")))
    assert {k: (v.shape, v.dtype) for k, v in fresh.items()} == \
        {k: (v.shape, v.dtype) for k, v in bridged.items()}
    assert torch.count_nonzero(fresh[("layers", "ln1")]) == 0


def test_get_config_knows_only_llama3():
    assert get_config("llama3-8b").d_model == 4096
    with pytest.raises(KeyError):
        get_config("qwen3-32b")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v
