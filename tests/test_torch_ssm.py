"""The SSM and hybrid families of the port against the JAX package's.

On the CPU in fp32 with TF32 off, from numpy inputs and JAX-drawn weights
bridged over (norm weights moved off zero by numpy draws); the tolerance
is ``tests/test_ssm.py``'s, ``atol = rtol = 1e-4``, for outputs, logits
and states alike:

  * ``ssd_chunked`` against JAX's and against both packages' ``ssd_ref``,
    the state carried across a split (the PPI->CPI contract of an
    attention-free model), and a padded last chunk that leaves ``h``
    alone;
  * ``ssm_block`` in prefill (one row padded: ``token_mask``) and in a
    decode step, and one hybrid layer of hymba;
  * ``DecoderModel.forward`` of mamba2 (SSM) and hymba (hybrid), with the
    caches (``h``, ``conv``, and hymba's ``k``/``v``);
  * the parameter layout, and a bf16 model keeping its norms and the
    SSM's per-head constants in fp32 at JAX's fixed values;
  * the slot executor against JAX's on cronus, disagg_lh and dp under
    ``tests/test_torch_moe.py``'s near-tie rule (``s_kv`` 128: JAX's
    16-token padded chunks never wrap), ``reset_slot``, the handoff of
    ``h``/``conv``, and ``ServeSpec(...).build`` with the launcher.
"""
import dataclasses
import functools
import importlib
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.core.executor import RealExecutor
from repro_torch.models import ssm as tssm
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import (FP32_KEYS, DecoderModel,
                                            init_params, layer_slice,
                                            param_shapes)
from repro_torch.serving.api import ServeSpec
from test_torch_moe import (LENS, S_KV, _compare, _jax_forward,
                            _perturb_norms, _serve, _shapes, _tensors)

ARCHS = ["mamba2-780m", "hymba-1.5b"]
TOL = 1e-4

# the JAX functions, compiled once per shape rather than once per eager op
JAX_SSD = jax.jit(jssm.ssd_chunked, static_argnums=(6,))
JAX_REF = jax.jit(jssm.ssd_ref)
JAX_BLOCK = jax.jit(jssm.ssm_block, static_argnums=(1,),
                    static_argnames=("decode",))


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

def _scan_inputs(b, s, h, p, n, seed=0):
    """The inputs of ``tests/test_ssm.py``, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1
    a_neg = -np.exp(rng.standard_normal(h) * 0.3)
    b_in = rng.standard_normal((b, s, n))
    c_in = rng.standard_normal((b, s, n))
    h0 = rng.standard_normal((b, h, p, n)) * 0.1
    return [a.astype(np.float32) for a in (x, dt, a_neg, b_in, c_in, h0)]


def _both(args):
    return ([torch.from_numpy(a) for a in args],
            [jnp.asarray(a) for a in args])


@pytest.mark.parametrize("s,chunk", [(1, 4), (13, 8), (40, 16), (64, 16)])
def test_ssd_chunked_matches_jax_and_the_oracles(s, chunk):
    targs, jargs = _both(_scan_inputs(2, s, 3, 4, 5))
    y, h = tssm.ssd_chunked(*targs, chunk)
    jy, jh = JAX_SSD(*jargs, chunk)
    for ref_y, ref_h in (tssm.ssd_ref(*targs), JAX_REF(*jargs),
                         (jy, jh)):
        _close(y, ref_y)
        _close(h, ref_h)


@pytest.mark.parametrize("split", [1, 13, 31])
def test_ssd_state_carry(split):
    """scan(x) == scan(x[:split]) then scan(x[split:], h_mid): the PPI ->
    CPI state handoff; the whole scan is held to JAX's too."""
    targs, jargs = _both(_scan_inputs(1, 32, 2, 4, 3, seed=1))
    x, dt, a_neg, b_in, c_in, h0 = targs
    y_full, h_full = tssm.ssd_chunked(*targs, 8)
    jy, jh = JAX_SSD(*jargs, 8)
    _close(y_full, jy)
    _close(h_full, jh)
    y1, h_mid = tssm.ssd_chunked(x[:, :split], dt[:, :split], a_neg,
                                 b_in[:, :split], c_in[:, :split], h0, 8)
    y2, h_end = tssm.ssd_chunked(x[:, split:], dt[:, split:], a_neg,
                                 b_in[:, split:], c_in[:, split:], h_mid, 8)
    _close(torch.cat([y1, y2], 1), y_full)
    _close(h_end, h_full)


def test_ssd_padding_neutral():
    """A length not divisible by the chunk: the padding leaves h alone."""
    targs, _ = _both(_scan_inputs(1, 13, 2, 4, 3, seed=2))
    _, h_a = tssm.ssd_chunked(*targs, 8)
    _, h_b = tssm.ssd_ref(*targs)
    _close(h_a, h_b)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _setup(arch):
    """One arch's configs, weights, models and prompts, in the namespace
    ``tests/test_torch_moe.py``'s serving helpers read."""
    cfg = get_config(arch, smoke=True)
    jcfg = jax_get_config(arch, smoke=True)
    jmodel = build_model(jcfg, exact_moe=True)
    tree = _perturb_norms(jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0))), np.random.default_rng(1))
    model = DecoderModel(cfg, params_from_numpy(tree, cfg, device="cpu"),
                         device="cpu", exact_moe=True)
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _ in LENS]
    return types.SimpleNamespace(cfg=cfg, jcfg=jcfg, jmodel=jmodel,
                                 tree=tree,
                                 jparams=jax.tree.map(jnp.asarray, tree),
                                 model=model, prompts=prompts, fwd=None,
                                 direct=None)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_layout_equals_jax(arch):
    jtree = jax.eval_shape(build_model(jax_get_config(arch, smoke=True))
                           .init_params, jax.random.PRNGKey(0))
    assert param_shapes(get_config(arch, smoke=True)) == _shapes(jtree)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_keeps_the_fp32_leaves(arch):
    """In bf16, the norms and ``A_log``, ``dt_bias``, ``D``, ``conv_b``
    stay fp32, from the bridge and from ``init_params`` alike, and the
    fixed ones hold JAX's values; every other leaf is bf16."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    tree = _setup(arch).tree
    drawn = init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    bridged = params_from_numpy(tree, cfg, device="cpu")
    for params in (drawn, bridged):
        for key, t in _flatten(params):
            want = torch.float32 if key[-1] in FP32_KEYS else torch.bfloat16
            assert t.dtype == want, key
    for k in ("A_log", "dt_bias", "D", "conv_b"):
        _close(drawn["layers"]["ssm"][k], tree["layers"]["ssm"][k], 1e-6)
    assert torch.equal(bridged["layers"]["ssm"]["A_log"], torch.from_numpy(
        np.array(tree["layers"]["ssm"]["A_log"])))


def _block_case(s, rng):
    """Layer 0's SSM weights of mamba2's smoke model, an input of two rows
    (the second padded after 5 tokens) and a nonzero state."""
    cfg = s.cfg
    p = layer_slice(s.tree["layers"], 0)["ssm"]
    d_inner, h, hp, n, conv_dim = tssm.ssm_dims(cfg)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    mask = np.ones((2, 11), bool)
    mask[1, 5:] = False
    cache = {"h": rng.standard_normal((2, h, hp, n)).astype(np.float32)
             * 0.1,
             "conv": rng.standard_normal((2, cfg.ssm_conv_width - 1,
                                          conv_dim)).astype(np.float32)}
    return p, x, mask, cache


def test_ssm_block_matches_jax_in_prefill_and_decode():
    s = _setup("mamba2-780m")
    rng = np.random.default_rng(3)
    p, x, mask, cache = _block_case(s, rng)
    tp = _tensors(p)
    out, new = tssm.ssm_block(tp, s.cfg, torch.from_numpy(x),
                              _tensors(cache),
                              token_mask=torch.from_numpy(mask))
    jout, jnew = JAX_BLOCK(p, s.jcfg, jnp.asarray(x), cache,
                           token_mask=jnp.asarray(mask))
    _close(out[torch.from_numpy(mask)], np.asarray(jout)[mask])
    for k in ("h", "conv"):
        _close(new[k], jnew[k])
    # the padded row's state moved by its 5 real tokens only
    _, five = tssm.ssm_block(tp, s.cfg, torch.from_numpy(x[1:, :5]),
                             _tensors({k: v[1:] for k, v in cache.items()}))
    for k in ("h", "conv"):
        _close(new[k][1:], five[k])
    # one decode step (the recurrent update) from that state
    x1 = rng.standard_normal((2, 1, s.cfg.d_model)).astype(np.float32)
    out, dec = tssm.ssm_block(tp, s.cfg, torch.from_numpy(x1), new,
                              decode=True)
    jout, jdec = JAX_BLOCK(p, s.jcfg, jnp.asarray(x1), jnew, decode=True)
    _close(out, jout)
    for k in ("h", "conv"):
        _close(dec[k], jdec[k])


def test_hybrid_layer_matches_jax():
    """Layer 0 of hymba (attention and SSM in parallel, each RMS-normed,
    averaged, then the MLP) on a 12-token chunk over an empty cache."""
    s = _setup("hymba-1.5b")
    rng = np.random.default_rng(5)
    b, c, s_kv = 1, 12, 32
    x = rng.standard_normal((b, c, s.cfg.d_model)).astype(np.float32)
    positions = np.arange(c, dtype=np.int32)[None]
    kv_pos = np.full((b, s_kv), -1, np.int32)
    kv_pos[0, :c] = np.arange(c)
    idx = positions % s_kv
    jlc = jax.tree.map(lambda a: a[0], s.jmodel.init_cache(b, s_kv)["stack"])
    layer = jax.jit(s.jmodel._layer, static_argnums=(0, 8))
    jx, jlc, _ = layer(
        "hybrid", jax.tree.map(lambda a: a[0], s.jparams["layers"]),
        jnp.asarray(x), jnp.asarray(positions), jnp.asarray(kv_pos),
        jnp.asarray(idx), jlc, 0, False, jnp.zeros(()))
    lc = {k: a[0] for k, a in s.model.init_cache(b, s_kv)["stack"].items()}
    with torch.no_grad():
        tx, _ = s.model._layer(
            "hybrid", layer_slice(s.model.params["layers"], 0),
            torch.from_numpy(x), torch.from_numpy(positions),
            torch.from_numpy(kv_pos), torch.from_numpy(idx).long(), lc, 0,
            None, torch.zeros(()), False)
    _close(tx, jx)
    for k in ("k", "v", "h", "conv"):
        _close(lc[k], jlc[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    """A 16-token prefill chunk on two rows (the second padded after 11),
    then a decode step (``decode=True``: the recurrent update): logits and
    every cache leaf equal to JAX's."""
    s = _setup(arch)
    rng = np.random.default_rng(4)
    b, c, s_kv = 2, 16, 40
    toks = rng.integers(0, s.cfg.vocab_size, (b, c)).astype(np.int32)
    positions = np.tile(np.arange(c, dtype=np.int32), (b, 1))
    positions[1, 11:] = -1
    kv_pos = np.full((b, s_kv), -1, np.int32)
    kv_pos[0, :c] = np.arange(c)
    kv_pos[1, :11] = np.arange(11)
    lens = np.zeros((b,), np.int32)
    jcache, cache = s.jmodel.init_cache(b, s_kv), s.model.init_cache(b, s_kv)
    for step in range(2):
        jl, jcache, _ = _jax_forward(
            s, s.jparams, jnp.asarray(toks), jcache, jnp.asarray(lens),
            jnp.asarray(positions), jnp.asarray(kv_pos), step == 1)
        with torch.no_grad():
            tl, cache, _ = s.model.forward(
                s.model.params, torch.from_numpy(toks), cache,
                torch.from_numpy(lens), positions=torch.from_numpy(positions),
                kv_positions=torch.from_numpy(kv_pos), decode=step == 1)
        live = positions >= 0
        _close(tl.numpy()[live], np.asarray(jl)[live])
        assert set(cache["stack"]) == set(jcache["stack"])
        for key, a in cache["stack"].items():
            _close(a, jcache["stack"][key])
        if step == 0:            # then one decode step from 16 and 11
            lens = np.asarray([c, 11], np.int32)
            toks = rng.integers(0, s.cfg.vocab_size, (b, 1)).astype(np.int32)
            positions = lens[:, None].copy()
            kv_pos[0, c], kv_pos[1, 11] = c, 11


# ---------------------------------------------------------------------------
# the slot executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("approach", ["cronus", "disagg_lh", "dp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_slot_executor_matches_jax(arch, approach):
    s = _setup(arch)
    got, parts = _serve("torch", s, approach)
    want, want_parts = _serve("jax", s, approach)
    assert parts == want_parts
    assert _compare(got, want) <= 1
    if approach == "cronus":     # the PPI handed a partial prefill over
        assert any(0 < parts[f"r{i}"] < n for i, (n, _) in enumerate(LENS))


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_slot_zeroes_the_state(arch):
    s = _setup(arch)
    ex = RealExecutor(s.model, max_slots=2, s_kv=S_KV)
    for slot in (0, 1):
        ex.prefill_chunk(slot, s.prompts[slot], 0, True)
    stack = ex.cache["stack"]
    kept = {k: stack[k][:, 0].clone() for k in ("h", "conv")}
    assert all(stack[k][:, 1].abs().sum() > 0 for k in ("h", "conv"))
    ex.reset_slot(1)
    for k in ("h", "conv"):
        assert not stack[k][:, 1].any()
        assert torch.equal(stack[k][:, 0], kept[k])
    assert (ex.pos[1] == -1).all() and ex.lens[1] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_handoff_carries_the_state(arch):
    """The PPI's state after ``upto`` tokens arrives on the CPI (another
    slot of another executor): the rest of the prompt and two decode
    steps then give the logits of an unsplit run."""
    s = _setup(arch)
    prompt, split = s.prompts[1], 20
    whole = RealExecutor(s.model, max_slots=2, s_kv=S_KV)
    wtok = whole.prefill_chunk(0, prompt, 0, True)
    ppi = RealExecutor(s.model, max_slots=2, s_kv=S_KV)
    cpi = RealExecutor(s.model, max_slots=3, s_kv=S_KV)
    ppi.prefill_chunk(1, prompt[:split], 0, False)
    payload = ppi.extract_kv(1, split)
    assert {"h", "conv"} <= set(payload["stack"])
    ppi.reset_slot(1)
    cpi.inject_kv(2, payload, split)
    for k in ("h", "conv"):
        assert payload["stack"][k].abs().sum() > 0
        assert torch.equal(cpi.cache["stack"][k][:, 2], payload["stack"][k])
    tok = cpi.prefill_chunk(2, prompt[split:], split, True)
    _close(cpi.last_logits, whole.last_logits)
    assert tok == wtok
    n = len(prompt)
    for step in range(2):
        wtok = whole.decode({0: wtok}, {0: n + step})[0]
        tok = cpi.decode({2: tok}, {2: n + step})[2]
        _close(cpi.last_logits, whole.last_logits)


# ---------------------------------------------------------------------------
# the serving surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ["whisper-base"])
def test_serve_spec_and_launcher_serve_the_arch(arch, monkeypatch, capsys):
    """``ServeSpec(arch=..., executor="real").build`` raises without a
    card and serves 4/4 on the CPU; so does the launcher."""
    from repro_torch.serving.trace import make_trace
    spec = ServeSpec(arch=arch, smoke=True, executor="real", s_kv=128,
                     max_slots=4, block_size=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            spec.build()
    cfg = get_config(arch, smoke=True)
    res = spec.build(device="cpu").run(
        make_trace(4, seed=0, vocab_size=cfg.vocab_size, scale=0.01))
    assert res["completed"] == 4
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--smoke", "--executor", "real",
        "--n-requests", "4", "--scale", "0.02", "--device", "cpu"])
    importlib.import_module("repro_torch.launch.serve").main()
    assert json.loads(capsys.readouterr().out)["completed"] == 4
