"""The MoE stack of the port against the JAX package's.

On the CPU in fp32 with TF32 off, from numpy inputs and JAX-drawn weights
bridged over (norm weights moved off zero by numpy draws):

  * ``moe_block`` in exact and capacity mode, at kimi-k2's smoke config
    (E 4, top-2, 1 shared) and at a variant with deepseek-v2's ratios (E
    16, top-6, 2 shared), against JAX's ``moe_block`` and
    ``moe_block_dense_ref``: outputs within 1e-4, ``aux`` within 1e-5,
    and in capacity mode (96 tokens, capacity factor 1.25, so pairs
    drop) the same kept ``(token, expert)`` pairs, read off JAX's output;
  * exact mode is permutation equivariant;
  * the parameter layout equals the JAX pytree's for both smoke archs;
  * kimi-k2's ``DecoderModel.forward`` (GQA, a dense first layer, then
    MoE) on a prefill chunk and a decode step: logits within 1e-4, ``aux``
    within 1e-5 (deepseek-v2's, with MLA, is in ``test_torch_mla.py``);
  * both archs served by the slot executor against JAX's on cronus,
    disagg_lh and dp, an extract -> inject round trip that carries the
    dense layers' cache, the launcher's JSON, and the paged executor's
    refusal (in ``test_torch_families.py``);
  * capacity mode under the slot executors: equal to JAX where one
    slot's chunks fill their bucket, equal to the port's own exact-width
    run where JAX's padding takes capacity.

Routing near-ties: the two frameworks sum the router's products in
different orders, so a token whose k-th and (k+1)-th probabilities lie
within ``TIE_GAP`` may pick another expert. Such tokens are counted,
held to a small number and left out of the output comparison.
"""
import dataclasses
import functools
import importlib
import itertools
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.executor import RealExecutor as JaxRealExecutor
from repro.core.request import Request as JaxRequest
from repro.models import build_model
from repro.models import moe as jmoe
from repro.serving import hardware as jax_hw
from repro.serving.simulator import build_system as jax_build_system
from repro_torch.configs import get_config
from repro_torch.core.executor import GREEDY_TIE_MARGIN, RealExecutor
from repro_torch.core.request import Request
from repro_torch.models import moe as tmoe
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import (NORM_KEYS, DecoderModel,
                                            param_shapes)
from repro_torch.serving import hardware
from repro_torch.serving.api import slot_executor_factory
from repro_torch.serving.simulator import build_system

ARCHS = ["deepseek-v2-236b", "kimi-k2-1t-a32b"]
# the sizes of tests/test_torch_slot.py
S_KV, SLOTS, CHUNK, BLOCK = 128, 4, 16, 4
NBLK = SLOTS * (S_KV // BLOCK)
LENS = [(17, 5), (33, 8), (9, 4), (41, 6), (25, 3)]
LOGIT_TOL = 1e-4
# a router-probability gap below which fp32 reorderings may flip top-k
TIE_GAP = 1e-5

# the JAX functions, compiled once per shape rather than once per eager op
JAX_MOE = jax.jit(jmoe.moe_block, static_argnums=(1, 3))
JAX_MOE_REF = jax.jit(jmoe.moe_block_dense_ref, static_argnums=(1,))

# kimi-k2's smoke MoE, and one with deepseek-v2's ratios (E/k ~ 27 -> 2.7,
# two shared experts)
VARIANTS = {"kimi": {}, "deepseek-ratio": dict(n_experts=16, top_k=6,
                                                n_shared_experts=2)}


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


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _moe_case(variant):
    """A config, one MoE layer's weights (numpy, from JAX's ``init_moe``)
    and 96 tokens of input. The tokens share one offset, as hidden states
    share a mean direction, so the router favours some experts and
    capacity mode drops pairs."""
    over = VARIANTS[variant]
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b", smoke=True),
                              **over)
    jcfg = dataclasses.replace(jax_get_config("kimi-k2-1t-a32b", smoke=True),
                               **over)
    tree = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(3),
                                                 jcfg))
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 48, cfg.d_model))
         + rng.standard_normal(cfg.d_model)).astype(np.float32)
    return cfg, jcfg, tree, x


def _near_ties(jcfg, tree, x):
    """Tokens whose k-th and (k+1)-th JAX router probabilities lie within
    TIE_GAP, and JAX's top-k experts of every token."""
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = np.asarray(jax.nn.softmax(xt @ tree["router"], axis=-1))
    srt = np.sort(probs, axis=-1)[:, ::-1]
    k = jcfg.top_k
    _, idx = jax.lax.top_k(jnp.asarray(probs), k)
    return srt[:, k - 1] - srt[:, k] < TIE_GAP, np.asarray(idx)


def _jax_kept_pairs(jcfg, tree, x):
    """The ``(token, expert)`` pairs JAX's capacity mode keeps, read off
    its output: with the shared experts taken out, each token's output is
    the sum of its kept experts' weighted outputs, and exactly one subset
    of its top-k fits."""
    cfg0 = dataclasses.replace(jcfg, n_shared_experts=0)
    out, _ = JAX_MOE(tree, cfg0, jnp.asarray(x), False)
    out = np.asarray(out, np.float64).reshape(-1, x.shape[-1])
    xt = x.reshape(-1, x.shape[-1]).astype(np.float64)
    logits = xt @ tree["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    k = jcfg.top_k
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    w = np.take_along_axis(probs, idx, -1)
    w /= w.sum(-1, keepdims=True)

    def silu(a):
        return a / (1.0 + np.exp(-a))
    y = np.stack([(silu(xt @ tree["w_gate"][e]) * (xt @ tree["w_up"][e]))
                  @ tree["w_down"][e] for e in range(jcfg.n_experts)])
    subsets = np.array(list(itertools.product((0, 1), repeat=k)), float)
    kept = set()
    for t in range(xt.shape[0]):
        contrib = w[t][:, None] * y[idx[t], t]                  # [k, d]
        resid = np.linalg.norm(subsets @ contrib - out[t], axis=-1)
        best, second = np.sort(resid)[:2]
        assert best < 1e-4 and second > 1e-2, (t, best, second)
        s = subsets[np.argmin(resid)]
        kept |= {(t, int(idx[t, j])) for j in range(k) if s[j]}
    return kept


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "capacity"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_block_matches_jax(variant, exact):
    cfg, jcfg, tree, x = _moe_case(variant)
    jout, jaux = JAX_MOE(tree, jcfg, jnp.asarray(x), exact)
    p = _tensors(tree)
    out, aux = tmoe.moe_block(p, cfg, torch.from_numpy(x), exact=exact)
    ties, jidx = _near_ties(jcfg, tree, x)
    assert ties.sum() <= 1
    _, _, idx = tmoe.route(p, cfg, torch.from_numpy(x).reshape(-1,
                                                               cfg.d_model))
    same = (np.sort(idx.numpy(), -1) == np.sort(jidx, -1)).all(-1)
    assert (same | ties).all()
    live = (~ties).reshape(x.shape[:2])
    np.testing.assert_allclose(out.numpy()[live], np.asarray(jout)[live],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-5)
    if exact:
        ref = JAX_MOE_REF(tree, jcfg, jnp.asarray(x))
        tref = tmoe.moe_block_dense_ref(p, cfg, torch.from_numpy(x))
        for got in (out, tref):
            np.testing.assert_allclose(got.numpy()[live],
                                       np.asarray(ref)[live], rtol=1e-4,
                                       atol=1e-4)
        return
    # capacity mode: pairs drop, and the port keeps exactly JAX's
    assert not ties.any()        # a flip would move other tokens' ranks
    t = x.shape[0] * x.shape[1]
    pairs, kept, dropped = tmoe.dispatch(idx, cfg.n_experts,
                                         tmoe.capacity(t, cfg, False))
    assert int(dropped) > 0 and int(kept.sum()) + int(dropped) == t * cfg.top_k
    k = cfg.top_k
    got = {(int(f) // k, int(idx.reshape(-1)[f])) for f in pairs}
    assert got == _jax_kept_pairs(jcfg, tree, x)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_exact_is_permutation_equivariant(variant):
    cfg, _, tree, x = _moe_case(variant)
    p = _tensors(tree)
    xt = torch.from_numpy(x).reshape(1, -1, cfg.d_model)
    perm = torch.from_numpy(np.random.default_rng(6).permutation(
        xt.shape[1]))
    out, aux = tmoe.moe_block(p, cfg, xt, exact=True)
    pout, paux = tmoe.moe_block(p, cfg, xt[:, perm], exact=True)
    np.testing.assert_allclose(pout[0].numpy(), out[0, perm].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(paux), float(aux), rtol=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch,over", [
    ("deepseek-v2-236b", {}), ("deepseek-v2-236b", dict(mla_q_lora_rank=0)),
    ("kimi-k2-1t-a32b", {})], ids=["deepseek-v2", "deepseek-v2-no-q-lora",
                                   "kimi-k2"])
def test_param_layout_equals_jax(arch, over):
    """Key sets and shapes of the JAX pytree (the bridge checks both)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **over)
    jtree = jax.eval_shape(build_model(jcfg).init_params,
                           jax.random.PRNGKey(0))
    assert param_shapes(cfg) == _shapes(jtree)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """One arch's configs, weights, models, prompts and the JAX slot
    executor's shared jitted forward, built once for the module."""
    cfg = get_config(arch, smoke=True)
    jcfg = jax_get_config(arch, smoke=True)
    jmodel = build_model(jcfg, exact_moe=True)
    tree = _perturb_norms(jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0))), np.random.default_rng(1))
    jparams = jax.tree.map(jnp.asarray, tree)
    model = DecoderModel(cfg, params_from_numpy(tree, cfg, device="cpu"),
                         device="cpu", exact_moe=True)
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _ in LENS]
    return types.SimpleNamespace(cfg=cfg, jcfg=jcfg, jmodel=jmodel,
                                 jparams=jparams, model=model,
                                 prompts=prompts, fwd=None, direct=None)


def _jax_forward(s, *a):
    """JAX's forward(params, inputs, cache, cache_len, positions,
    kv_positions), jitted once per arch."""
    if s.direct is None:
        s.direct = jax.jit(lambda *a: s.jmodel.forward(
            *a[:4], positions=a[4], kv_positions=a[5], decode=a[6]),
            static_argnums=(6,))
    return s.direct(*a)


def test_kimi_forward_matches_jax():
    """A 16-token prefill chunk on two rows (one padded), then a decode
    step: logits within 1e-4, aux within 1e-5, both caches (the dense
    first layer's and the MoE stack's) equal to JAX's."""
    s = _setup("kimi-k2-1t-a32b")
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
        jl, jcache, jaux = _jax_forward(
            s, s.jparams, jnp.asarray(toks), jcache, jnp.asarray(lens),
            jnp.asarray(positions), jnp.asarray(kv_pos), step == 1)
        with torch.no_grad():
            tl, cache, aux = s.model.forward(
                s.model.params, torch.from_numpy(toks), cache,
                torch.from_numpy(lens), positions=torch.from_numpy(positions),
                kv_positions=torch.from_numpy(kv_pos))
        live = positions >= 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                                   atol=1e-5)
        assert float(aux) > 0
        for group in ("dense", "stack"):
            for key in ("k", "v"):
                np.testing.assert_allclose(cache[group][key].numpy(),
                                           np.asarray(jcache[group][key]),
                                           rtol=1e-5, atol=1e-5)
        if step == 0:            # then one decode step from 16 and 11
            lens = np.asarray([c, 11], np.int32)
            toks = rng.integers(0, s.cfg.vocab_size, (b, 1)).astype(np.int32)
            positions = lens[:, None].copy()
            kv_pos[0, c], kv_pos[1, 11] = c, 11


# ---------------------------------------------------------------------------
# serving: torch slot vs JAX slot
# ---------------------------------------------------------------------------

class _JaxSlot(JaxRealExecutor):
    """The JAX slot executor on the arch's one jitted forward, keeping the
    logits rows it picks from."""

    def __init__(self, s, *a, **kw):
        super().__init__(s.jmodel, s.jparams, *a, **kw)
        if s.fwd is None:
            s.fwd = self._fwd
        self._fwd = s.fwd
        self.last_logits = None

    def _run(self, *a, **kw):
        logits = super()._run(*a, **kw)
        self._logits = np.asarray(logits, np.float32)
        return logits

    def prefill_chunk(self, slot, tokens, ctx_len, completes, enc_emb=None):
        tok = super().prefill_chunk(slot, tokens, ctx_len, completes,
                                    enc_emb)
        if completes:
            self.last_logits = self._logits[slot, len(tokens) - 1][None]
        return tok

    def decode(self, slot_tokens, slot_lens):
        out = super().decode(slot_tokens, slot_lens)
        self.last_logits = self._logits[sorted(slot_tokens), 0]
        return out


def _recording(ex, slots):
    """Keep every emitted token's logits row: ``rows[(req_id, index)] =
    (logits, token)``."""
    rows = {}
    prefill, decode = ex.prefill_chunk, ex.decode

    def req(slot):
        r = slots[slot]
        return r.req_id, len(r.generated)

    def prefill_chunk(slot, tokens, ctx_len, completes, enc_emb=None):
        tok = prefill(slot, tokens, ctx_len, completes, enc_emb)
        if completes:
            rows[req(slot)] = (ex.last_logits[0].copy(), tok)
        return tok

    def decode_(slot_tokens, slot_lens):
        out = decode(slot_tokens, slot_lens)
        for i, sl in enumerate(sorted(slot_tokens)):
            rows[req(sl)] = (ex.last_logits[i].copy(), out[sl])
        return out
    ex.prefill_chunk, ex.decode = prefill_chunk, decode_
    return rows


def _engines(system):
    if hasattr(system, "engines"):               # DPSystem
        return system.engines
    return [system.ppi, system.cpi]              # CronusSystem


def _serve(kind, s, approach):
    """The 5-request trace at t=0; returns {(req, i): (logits, token)} and
    each request's Balancer split."""
    if kind == "jax":
        def factory(role):
            return _JaxSlot(s, max_slots=SLOTS, s_kv=S_KV, chunk_pad=CHUNK)
        build, cfg, hw, cls = jax_build_system, s.jcfg, jax_hw, JaxRequest
    else:
        factory = slot_executor_factory(s.cfg, s.model, device="cpu",
                                        max_slots=SLOTS, s_kv=S_KV,
                                        chunk_pad=CHUNK)
        build, cfg, hw, cls = build_system, s.cfg, hardware, Request
    system = build(approach, cfg, hw.A100, hw.A30, executor_factory=factory,
                   max_slots=SLOTS, block_size=BLOCK,
                   max_batched_tokens=CHUNK, num_kv_blocks=NBLK,
                   executor="real")
    reqs = [cls(req_id=f"r{i}", prompt=s.prompts[i].copy(),
                output_len=LENS[i][1], arrival=0.0)
            for i in range(len(LENS))]
    recorded = [_recording(e.executor, e.slots) for e in _engines(system)]
    res = system.run(reqs)
    assert res["completed"] == len(LENS)
    rows = {}
    for r in recorded:           # filled during the run
        rows.update(r)
    return rows, {r.req_id: r.partial_len for r in reqs}


def _compare(got, want):
    """Logits within LOGIT_TOL at every compared step; a token differs
    only at a near-tie, and the request is compared no further. Returns
    the number of near-tie divergences."""
    assert want and set(got) == set(want)
    by_req = {}
    for key in sorted(want):
        by_req.setdefault(key[0], []).append(key)
    ties = 0
    for keys in by_req.values():
        for key in keys:
            (la, ta), (lb, tb) = got[key], want[key]
            diff = float(np.abs(la - lb).max())
            assert diff <= LOGIT_TOL, (key, diff)
            if ta == tb:
                continue
            slack = GREEDY_TIE_MARGIN + diff
            assert all(row[t] >= row.max() - slack
                       for row in (la, lb) for t in (ta, tb)), key
            ties += 1
            break
    return ties


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
def test_extract_inject_carries_the_dense_layers(arch):
    """A partial prefill extracted from one executor and injected into
    another slot of a second carries the dense first layer's cache too:
    the rest of the prompt and two decode steps then give the logits of
    an unsplit run."""
    s = _setup(arch)
    prompt = s.prompts[1]
    split = 20
    whole = RealExecutor(s.model, max_slots=2, s_kv=S_KV)
    wtok = whole.prefill_chunk(0, prompt, 0, True)
    ppi = RealExecutor(s.model, max_slots=2, s_kv=S_KV)
    cpi = RealExecutor(s.model, max_slots=3, s_kv=S_KV)
    ppi.prefill_chunk(1, prompt[:split], 0, False)
    payload = ppi.extract_kv(1, split)
    assert set(payload) == {"stack", "dense", "_upto"}
    ppi.reset_slot(1)
    cpi.inject_kv(2, payload, split)
    for group, keys in payload.items():
        if group == "_upto":
            continue
        for k, a in keys.items():
            assert torch.equal(cpi.cache[group][k][:, 2, :split], a)
    tok = cpi.prefill_chunk(2, prompt[split:], split, True)
    np.testing.assert_allclose(cpi.last_logits, whole.last_logits,
                               rtol=1e-4, atol=1e-4)
    assert tok == wtok
    n = len(prompt)
    for step in range(2):
        wtok = whole.decode({0: wtok}, {0: n + step})[0]
        tok = cpi.decode({2: tok}, {2: n + step})[2]
        np.testing.assert_allclose(cpi.last_logits, whole.last_logits,
                                   rtol=1e-4, atol=1e-4)


def test_capacity_mode_departure_from_the_jax_slot_executor(monkeypatch):
    """Capacity mode (``exact_moe=False``) under the slot executors. JAX
    forwards ``max_slots`` rows at the padded width, so its drop rule
    ranks padding and idle slots' rows with the real tokens; the port
    forwards only the real tokens (``RealExecutor``'s docstring).

    With one slot and chunks that fill their 16-token bucket exactly, the
    two rank the same tokens: the logits agree, with pairs dropped. Where
    JAX's padding takes capacity (slot 1 of 2, a 12-token chunk: 32 rows
    compete in JAX, 12 in the port), the port equals its own run of the
    12 tokens at their exact width and JAX's logits differ."""
    s = _setup("kimi-k2-1t-a32b")
    jcap = types.SimpleNamespace(jmodel=build_model(s.jcfg, exact_moe=False),
                                 jparams=s.jparams, fwd=None)
    model = DecoderModel(s.cfg, s.model.params, device="cpu",
                         exact_moe=False)
    drops = []
    dispatch = tmoe.dispatch

    def counted(idx, n_experts, cap):
        out = dispatch(idx, n_experts, cap)
        drops.append(int(out[2]))
        return out
    monkeypatch.setattr(tmoe, "dispatch", counted)
    prompt = np.random.default_rng(2).integers(0, s.cfg.vocab_size,
                                               32).astype(np.int32)
    jax_ex = _JaxSlot(jcap, max_slots=1, s_kv=S_KV)
    ex = RealExecutor(model, max_slots=1, s_kv=S_KV)
    for e in (jax_ex, ex):
        e.prefill_chunk(0, prompt[:16], 0, False)
        e.prefill_chunk(0, prompt[16:], 16, True)
    assert min(drops) > 0                  # both chunks dropped pairs
    np.testing.assert_allclose(ex.last_logits, jax_ex.last_logits,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)

    jax_ex = _JaxSlot(jcap, max_slots=2, s_kv=S_KV)
    ex = RealExecutor(model, max_slots=2, s_kv=S_KV)
    for e in (jax_ex, ex):
        e.prefill_chunk(1, prompt[:12], 0, True)
    with torch.no_grad():
        exact, _, _ = model.forward(model.params,
                                    torch.from_numpy(prompt[None, :12]),
                                    model.init_cache(1, S_KV),
                                    torch.zeros((1,), dtype=torch.int32))
    assert drops[-1] > 0
    np.testing.assert_array_equal(ex.last_logits, exact[:, -1].numpy())
    assert np.abs(ex.last_logits - jax_ex.last_logits).max() > 0.1


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [module, *argv])
    importlib.import_module(module).main()
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_real_executor_prints_the_jax_metrics(arch, monkeypatch,
                                                       capsys):
    argv = ["--arch", arch, "--smoke", "--executor", "real",
            "--n-requests", "4", "--scale", "0.02"]
    got = _main("repro_torch.launch.serve", argv + ["--device", "cpu"],
                monkeypatch, capsys)
    want = _main("repro.launch.serve", argv, monkeypatch, capsys)
    assert got == want
    assert got["completed"] == 4
