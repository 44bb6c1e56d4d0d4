"""The port's dry-run specs against the JAX package's, leaf for leaf.

``repro.launch.specs.make_serve_specs``/``make_train_specs`` run in this
process on an ``AbstractMesh`` (no devices); the port's
``repro_torch.launch.specs`` on its logical mesh of the same axes. For
every arch x input shape on 16x16, and for one dense, one MoE and the
encoder-decoder arch on 2x16x16, each argument leaf must have the same
path, shape, dtype and partition spec (as tuples). No dtype differs from
JAX's: token ids, ``cache_len`` and ``kv_positions`` are int32 in both.

JAX's spec functions trace each arch's ``init_params`` anew for every
shape; here each arch's abstract parameters are traced once per module
and replayed as zeros of the same shapes and dtypes (all the specs read
of them).
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.launch import specs as jax_specs
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_shape
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import leaves, make_specs

DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int32}
MULTI_POD_ARCHS = ("llama3-8b", "kimi-k2-1t-a32b", "whisper-base")


@pytest.fixture(scope="module", autouse=True)
def _abstract_params_once():
    """Each config's ``init_params`` traced once (``jax.eval_shape``)."""
    build, traced = jax_specs.build_model, {}

    def build_model(cfg, **kw):
        model = build(cfg, **kw)
        init = model.init_params

        def init_params(key):
            if cfg not in traced:
                traced[cfg] = jax.eval_shape(init, key)
            return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                traced[cfg])
        model.init_params = init_params
        return model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_specs, "build_model", build_model)
        yield


@functools.lru_cache(maxsize=None)
def _jax_mesh(multi_pod):
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _jax_leaves(arch, shape_name, multi_pod):
    cfg, shape = jax_get_config(arch), jax_get_shape(shape_name)
    fn = (jax_specs.make_train_specs if shape.kind == "train"
          else jax_specs.make_serve_specs)
    _, args = fn(cfg, shape, _jax_mesh(multi_pod), multi_pod=multi_pod)
    flat, _ = jax.tree_util.tree_flatten_with_path(args)
    return {_path(p): (tuple(s.shape), DTYPES[jnp.dtype(s.dtype)],
                       tuple(s.sharding.spec)) for p, s in flat}


def _torch_leaves(arch, shape_name, multi_pod):
    _, specs = make_specs(get_config(arch), get_shape(shape_name),
                          make_production_mesh(multi_pod=multi_pod),
                          multi_pod=multi_pod)
    pspecs = leaves(specs.pspecs)
    out = {}
    for k, t in leaves(specs.args).items():
        assert t.device.type == "meta", k
        out[k] = (tuple(t.shape), t.dtype, tuple(pspecs[k]))
    assert set(pspecs) == set(out)
    return out


def _check(arch, shape_name, multi_pod):
    want = _jax_leaves(arch, shape_name, multi_pod)
    got = _torch_leaves(arch, shape_name, multi_pod)
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax_16x16(arch, shape_name):
    _check(arch, shape_name, multi_pod=False)


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", MULTI_POD_ARCHS)
def test_specs_match_jax_2x16x16(arch, shape_name):
    _check(arch, shape_name, multi_pod=True)
