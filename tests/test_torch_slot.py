"""The slot executor of the port against the JAX package's.

Three layers, on the CPU in fp32 with the same numpy inputs and the
llama3-8b smoke weights drawn by JAX from PRNGKey(0) and bridged over:

  * the attention functions of the slot path (cache writes, mask, plain
    and blocked softmax attention, the attention block) within 1e-5;
  * ``DecoderModel.forward`` logits within 1e-4 on a prefill chunk and a
    decode step;
  * serving: torch-slot against JAX-slot (``RealExecutor``) and against
    torch-paged on cronus / disagg_lh / dp x maxtput / staggered.
    Logits agree within ``LOGIT_TOL`` at every step; a token may differ
    only where the top two logits lie within ``GREEDY_TIE_MARGIN`` (plus
    the logit difference), and the request's stream is compared no
    further after such a step. The port runs only the rows of the slots
    that take part in a forward, the JAX package every row, so the two
    are not bit-identical.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.executor import RealExecutor as JaxRealExecutor
from repro.core.request import Request as JaxRequest
from repro.models import attention as jattn
from repro.models import build_model
from repro.serving import hardware as jax_hw
from repro.serving.simulator import build_system as jax_build_system
from repro_torch.configs import get_config
from repro_torch.core.executor import GREEDY_TIE_MARGIN, RealExecutor
from repro_torch.core.request import Request
from repro_torch.models import attention as tattn
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import DecoderModel
from repro_torch.serving import hardware
from repro_torch.serving.api import (paged_executor_factory,
                                     slot_executor_factory)
from repro_torch.serving.simulator import build_system

# the sizes of tests/test_paged_executor.py
S_KV, SLOTS, CHUNK, BLOCK = 128, 4, 16, 4
NBLK = SLOTS * (S_KV // BLOCK)
LENS = [(17, 5), (33, 8), (9, 4), (41, 6), (25, 3)]
# fp32 logits of two frameworks / two layouts differ by ~1e-6
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("llama3-8b", smoke=True)
    jmodel = build_model(jcfg, exact_moe=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = get_config("llama3-8b", smoke=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    model = DecoderModel(cfg, params, device="cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _ in LENS]
    return types.SimpleNamespace(jcfg=jcfg, jmodel=jmodel, jparams=jparams,
                                 cfg=cfg, model=model, prompts=prompts)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# attention functions
# ---------------------------------------------------------------------------

def test_write_indices_and_scatter_tokens_ring():
    """Ring writes past the end wrap to the front; a chunk longer than the
    cache keeps its first S_kv tokens (the JAX "select" values); with
    ``rows`` the batch lands in the chosen cache rows only."""
    rng = np.random.default_rng(0)
    s_kv = 12
    cl = np.asarray([0, 9, 11], np.int32)
    for s_q in (1, 5, 16):
        idx = tattn.write_indices(torch.from_numpy(cl), s_q, s_kv)
        jidx = jattn.write_indices(jnp.asarray(cl), s_q, s_kv)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        buf = rng.standard_normal((3, s_kv, 2, 4)).astype(np.float32)
        new = rng.standard_normal((3, s_q, 2, 4)).astype(np.float32)
        want = np.asarray(jattn.scatter_tokens(jnp.asarray(buf),
                                               jnp.asarray(new), jidx,
                                               mode="select"))
        got = tattn.scatter_tokens(torch.from_numpy(buf.copy()),
                                   torch.from_numpy(new), idx)
        np.testing.assert_array_equal(got.numpy(), want)
        if s_q <= s_kv:          # no duplicate slots: scatter mode agrees
            np.testing.assert_array_equal(
                np.asarray(jattn.scatter_tokens(
                    jnp.asarray(buf), jnp.asarray(new), jidx,
                    mode="scatter")), want)
        # rows: batch row i -> cache row rows[i]; the other rows untouched
        big = np.concatenate([buf, buf], 0)
        rows = torch.tensor([3, 1, 5])
        got = tattn.scatter_tokens(torch.from_numpy(big.copy()),
                                   torch.from_numpy(new), idx, rows)
        np.testing.assert_array_equal(got.numpy()[[3, 1, 5]], want)
        np.testing.assert_array_equal(got.numpy()[[0, 2, 4]],
                                      big[[0, 2, 4]])


@pytest.mark.parametrize("window", [0, 3])
def test_make_mask(window):
    q_pos = np.asarray([[5, 6, -1], [0, 1, 2], [-1, -1, -1]], np.int32)
    kv_pos = np.asarray([[0, 1, 2, 3, 4, 5, 6, -1],
                         [-1, -1, -1, -1, -1, -1, -1, -1],
                         [0, 1, 2, 3, 4, 5, 6, 7]], np.int32)
    got = tattn.make_mask(torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                          window)
    want = jattn.make_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos), window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[1].any()                  # a row with no valid key


def _qkv(rng, b, sq, skv, h=4, kvh=2, d=16):
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    return q, k, v


def _positions(rng, b, sq, skv):
    """Queries at the end of a context with holes (-1) in the cache."""
    kv_pos = np.tile(np.arange(skv, dtype=np.int32), (b, 1))
    kv_pos[rng.random((b, skv)) < 0.2] = -1
    q_pos = np.tile(np.arange(skv - sq, skv, dtype=np.int32), (b, 1))
    q_pos[0, -1] = -1                        # a padded query
    return q_pos, kv_pos


@pytest.mark.parametrize("window", [0, 5])
def test_gqa_attend(window):
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 6, 20)
    q_pos, kv_pos = _positions(rng, 2, 6, 20)
    mask = jattn.make_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos), window)
    want = jattn.gqa_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            mask, 0.25)
    got = tattn.gqa_attend(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v),
                           torch.from_numpy(np.array(mask)), 0.25)
    _close(got, want)


@pytest.mark.parametrize("window", [0, 5])
def test_blocked_gqa_attend(window):
    """Small blocks, ragged in both directions (pads on q and kv)."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 2, 11, 29)
    q_pos, kv_pos = _positions(rng, 2, 11, 29)
    want = jattn.blocked_gqa_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(kv_pos), window, 0.25, block_q=4, block_k=8)
    got = tattn.blocked_gqa_attend(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(q_pos), torch.from_numpy(kv_pos), window, 0.25,
        block_q=4, block_k=8)
    _close(got, want)
    # and the plain path on the rows that have a valid key
    mask = tattn.make_mask(torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                           window)
    plain = tattn.gqa_attend(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), mask, 0.25)
    live = mask[:, 0].any(-1)
    _close(got[live], plain[live])


def test_attention_block(setup):
    """One layer's attention block with a cache write, both switch sides
    of BLOCKED_ATTN_THRESHOLD (lowered so the blocked path runs small)."""
    cfg, jcfg = setup.cfg, setup.jcfg
    rng = np.random.default_rng(3)
    b, sq, s_kv = 2, 8, 24
    x = rng.standard_normal((b, sq, cfg.d_model)).astype(np.float32)
    cl = np.asarray([3, 20], np.int32)
    positions = cl[:, None] + np.arange(sq, dtype=np.int32)[None]
    positions[0, -2:] = -1
    kv_pos = np.full((b, s_kv), -1, np.int32)
    for i in range(b):
        for p in range(cl[i] + sq):
            kv_pos[i, p % s_kv] = p
    kc = rng.standard_normal((b, s_kv, cfg.n_kv_heads, cfg.head_dim))
    vc = rng.standard_normal((b, s_kv, cfg.n_kv_heads, cfg.head_dim))
    kc, vc = kc.astype(np.float32), vc.astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], setup.jparams["layers"]["attn"])
    tp = {k: v[0] for k, v in setup.model.params["layers"]["attn"].items()}
    idx = jattn.write_indices(jnp.asarray(cl), sq, s_kv)
    for thresh in (tattn.BLOCKED_ATTN_THRESHOLD, 1):
        old = (jattn.BLOCKED_ATTN_THRESHOLD, tattn.BLOCKED_ATTN_THRESHOLD)
        jattn.BLOCKED_ATTN_THRESHOLD = tattn.BLOCKED_ATTN_THRESHOLD = thresh
        try:
            want, wcache = jattn.attention_block(
                jp, jcfg, jnp.asarray(x), jnp.asarray(positions),
                jnp.asarray(kv_pos), idx,
                {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, 0)
            lc = {"k": torch.from_numpy(kc.copy()),
                  "v": torch.from_numpy(vc.copy())}
            got, gcache = tattn.attention_block(
                tp, cfg, torch.from_numpy(x), torch.from_numpy(positions),
                torch.from_numpy(kv_pos), torch.from_numpy(np.array(idx)),
                lc, 0)
        finally:
            jattn.BLOCKED_ATTN_THRESHOLD, tattn.BLOCKED_ATTN_THRESHOLD = old
        live = positions >= 0                # padded queries differ
        _close(got.numpy()[live], np.asarray(want)[live])
        for key in ("k", "v"):
            _close(gcache[key], wcache[key])


# ---------------------------------------------------------------------------
# the serving forward
# ---------------------------------------------------------------------------

def test_forward_matches_jax_prefill_and_decode(setup):
    """A 16-token prefill chunk on two slots (one padded), then one decode
    step, through the whole smoke model: logits within 1e-4, and the
    cache written in place equal to JAX's new cache."""
    cfg = setup.cfg
    rng = np.random.default_rng(4)
    b, c, s_kv = 2, 16, 40
    toks = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
    positions = np.tile(np.arange(c, dtype=np.int32), (b, 1))
    positions[1, 11:] = -1
    kv_pos = np.full((b, s_kv), -1, np.int32)
    kv_pos[0, :c] = np.arange(c)
    kv_pos[1, :11] = np.arange(11)
    cl = np.zeros((b,), np.int32)

    jcache = setup.jmodel.init_cache(b, s_kv)
    cache = setup.model.init_cache(b, s_kv)
    jl, jcache, _ = setup.jmodel.forward(
        setup.jparams, jnp.asarray(toks), jcache, jnp.asarray(cl),
        positions=jnp.asarray(positions), kv_positions=jnp.asarray(kv_pos))
    with torch.no_grad():
        tl, cache, _ = setup.model.forward(
            setup.model.params, torch.from_numpy(toks), cache,
            torch.from_numpy(cl), positions=torch.from_numpy(positions),
            kv_positions=torch.from_numpy(kv_pos))
    live = positions >= 0
    _close(tl.numpy()[live], np.asarray(jl)[live], 1e-4)
    for key in ("k", "v"):
        _close(cache["stack"][key], jcache["stack"][key])

    # decode one token per slot from the lengths reached (16 and 11)
    lens = np.asarray([c, 11], np.int32)
    dtok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    dpos = lens[:, None].copy()
    kv_pos[0, c] = c
    kv_pos[1, 11] = 11
    jl, _, _ = setup.jmodel.forward(
        setup.jparams, jnp.asarray(dtok), jcache, jnp.asarray(lens),
        positions=jnp.asarray(dpos), kv_positions=jnp.asarray(kv_pos),
        decode=True)
    with torch.no_grad():
        tl, _, _ = setup.model.forward(
            setup.model.params, torch.from_numpy(dtok), cache,
            torch.from_numpy(lens), positions=torch.from_numpy(dpos),
            kv_positions=torch.from_numpy(kv_pos))
    _close(tl, jl, 1e-4)


def test_forward_refuses_what_is_not_ported(setup):
    """Nothing is refused any more: the training forward (no cache,
    positions ``arange(S)``) gives JAX's logits within 1e-4 and no cache;
    an SSM model builds, with its recurrent state in the slot cache and
    no attention cache."""
    tokens = np.random.default_rng(7).integers(
        0, setup.cfg.vocab_size, (2, 19)).astype(np.int32)
    jl, jcache, _ = setup.jmodel.forward(
        setup.jparams, jnp.asarray(tokens), None, jnp.zeros((2,), jnp.int32),
        train=True)
    with torch.no_grad():
        tl, cache, _ = setup.model.forward(
            setup.model.params, torch.from_numpy(tokens), None, None,
            train=True)
    assert cache is None and jcache is None
    _close(tl, jl, 1e-4)
    ssm = get_config("mamba2-780m", smoke=True)
    model = DecoderModel(ssm, device="cpu", generator=torch.Generator())
    assert model._stack_kind() == "ssm"
    assert set(model.init_cache(2, 16)["stack"]) == {"h", "conv"}


# ---------------------------------------------------------------------------
# serving: torch slot vs JAX slot, and vs torch paged
# ---------------------------------------------------------------------------

class _JaxSlot(JaxRealExecutor):
    """The JAX slot executor with one jitted forward per model, shared by
    every instance (compiling anew for every engine of every run would
    take most of this file's time), and the logits rows it picks from
    kept for the comparison."""

    _shared = {}

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._fwd = self._shared.setdefault(id(self.model), self._fwd)
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


def _recording(ex):
    """Wrap an executor so that every emitted token keeps its logits row:
    ``rows[(req_id, index)] = (logits, token)``."""
    rows = {}
    prefill, decode = ex.prefill_chunk, ex.decode

    def req(slot):
        r = ex._engine_slots[slot]
        return r.req_id, len(r.generated)

    def prefill_chunk(slot, tokens, ctx_len, completes, enc_emb=None):
        tok = prefill(slot, tokens, ctx_len, completes, enc_emb)
        if completes:
            rows[req(slot)] = (ex.last_logits[0].copy(), tok)
        return tok

    def decode_(slot_tokens, slot_lens):
        out = decode(slot_tokens, slot_lens)
        for i, s in enumerate(sorted(slot_tokens)):
            rows[req(s)] = (ex.last_logits[i].copy(), out[s])
        return out
    ex.prefill_chunk, ex.decode = prefill_chunk, decode_
    return rows


def _engines(system):
    if hasattr(system, "engines"):               # DPSystem
        return system.engines
    if hasattr(system, "engine"):                # PPSystem
        return [system.engine]
    return [system.ppi, system.cpi]              # CronusSystem


def _reqs(cls, prompts, staggered):
    reqs = [cls(req_id=f"r{i}", prompt=prompts[i].copy(),
                output_len=LENS[i][1], arrival=0.0)
            for i in range(len(LENS))]
    if staggered:
        for i, r in enumerate(reqs):
            r.arrival = i * 0.5
            r.metrics.arrival = r.arrival
    return reqs


def _serve(kind, s, approach, staggered):
    """Run the 5-request trace; returns {(req, i): (logits, token)} and
    each request's Balancer split."""
    if kind == "jax":
        def factory(role):
            return _JaxSlot(s.jmodel, s.jparams, max_slots=SLOTS,
                            s_kv=S_KV, chunk_pad=CHUNK)
        system = jax_build_system(
            approach, s.jcfg, jax_hw.A100, jax_hw.A30,
            executor_factory=factory, max_slots=SLOTS, block_size=BLOCK,
            max_batched_tokens=CHUNK, num_kv_blocks=NBLK, executor="real")
        reqs = _reqs(JaxRequest, s.prompts, staggered)
    else:
        if kind == "slot":
            factory = slot_executor_factory(s.cfg, s.model, device="cpu",
                                            max_slots=SLOTS, s_kv=S_KV,
                                            chunk_pad=CHUNK)
        else:
            factory = paged_executor_factory(s.cfg, s.model, device="cpu")
        system = build_system(
            approach, s.cfg, hardware.A100, hardware.A30,
            executor_factory=factory, max_slots=SLOTS, block_size=BLOCK,
            max_batched_tokens=CHUNK,
            num_kv_blocks=NBLK, executor="real" if kind == "slot"
            else "paged")
        reqs = _reqs(Request, s.prompts, staggered)
    rows = {}
    for e in _engines(system):
        e.executor._engine_slots = e.slots
        rows[e.name] = _recording(e.executor)
    res = system.run(reqs)
    assert res["completed"] == len(LENS)
    merged = {}
    for r in rows.values():
        merged.update(r)
    return merged, {r.req_id: r.partial_len for r in reqs}


def _compare(got, want):
    """Logits within LOGIT_TOL at every compared step; a token differs
    only at a near-tie, and the request is compared no further."""
    by_req = {}
    for key in sorted(want):
        by_req.setdefault(key[0], []).append(key)
    compared = 0
    for keys in by_req.values():
        for key in keys:
            (la, ta), (lb, tb) = got[key], want[key]
            diff = float(np.abs(la - lb).max())
            assert diff <= LOGIT_TOL, (key, diff)
            compared += 1
            if ta == tb:
                continue
            slack = GREEDY_TIE_MARGIN + diff
            assert all(row[t] >= row.max() - slack
                       for row in (la, lb) for t in (ta, tb)), key
            break
    assert compared >= len(by_req)
    return compared


MATRIX = [("cronus", False), ("cronus", True), ("disagg_lh", False),
          ("disagg_lh", True), ("dp", False), ("dp", True)]
IDS = [f"{a}-{'staggered' if st else 'maxtput'}" for a, st in MATRIX]


@pytest.mark.parametrize("approach,staggered", MATRIX, ids=IDS)
def test_slot_matches_jax_slot(setup, approach, staggered):
    got, parts = _serve("slot", setup, approach, staggered)
    want, want_parts = _serve("jax", setup, approach, staggered)
    assert set(got) == set(want)
    assert parts == want_parts
    _compare(got, want)


@pytest.mark.parametrize("approach,staggered", MATRIX, ids=IDS)
def test_slot_matches_torch_paged(setup, approach, staggered):
    got, parts = _serve("slot", setup, approach, staggered)
    want, want_parts = _serve("paged", setup, approach, staggered)
    assert set(got) == set(want)
    assert parts == want_parts
    _compare(got, want)
    if approach == "cronus" and not staggered:
        # the PPI really split a prompt and handed its K/V over
        assert any(0 < parts[f"r{i}"] < n for i, (n, _) in enumerate(LENS))


def test_extract_inject_roundtrip(setup):
    """The PPI payload holds only ``upto`` positions, equals the JAX
    executor's, is a snapshot (the PPI reuses the slot before the CPI
    installs it), and lands in the CPI's slot with positions [0, upto)."""
    upto = 21
    factory = slot_executor_factory(setup.cfg, setup.model, device="cpu",
                                    max_slots=SLOTS, s_kv=S_KV,
                                    chunk_pad=CHUNK)
    src, dst = factory("ppi"), factory("cpi")
    jsrc = _JaxSlot(setup.jmodel, setup.jparams, max_slots=2, s_kv=S_KV,
                    chunk_pad=CHUNK)
    prompt = setup.prompts[1]
    for lo in range(0, upto, CHUNK):
        hi = min(lo + CHUNK, upto)
        src.prefill_chunk(0, prompt[lo:hi], lo, False)
        jsrc.prefill_chunk(0, prompt[lo:hi], lo, False)
    payload = src.extract_kv(0, upto)
    jpay = jsrc.extract_kv(0, upto)
    assert payload["_upto"] == upto
    for key in ("k", "v"):
        assert tuple(payload["stack"][key].shape) == (
            setup.model.n_stack, upto, setup.cfg.n_kv_heads,
            setup.cfg.head_dim)
        _close(payload["stack"][key], jpay["stack"][key])
    want = {k: v.clone() for k, v in payload["stack"].items()}

    src.reset_slot(0)                        # the PPI reuses slot 0
    src.prefill_chunk(0, setup.prompts[3][:CHUNK], 0, False)
    assert not torch.equal(src.cache["stack"]["k"][:, 0, :upto],
                           want["k"])
    dst.inject_kv(2, payload, upto)
    for key in ("k", "v"):
        assert torch.equal(dst.cache["stack"][key][:, 2, :upto], want[key])
    np.testing.assert_array_equal(dst.pos[2, :upto], np.arange(upto))
    assert (dst.pos[2, upto:] == -1).all() and dst.lens[2] == upto
    # the next chunk on the CPI continues the prompt as one engine would
    tok = dst.prefill_chunk(2, prompt[upto:upto + 4], upto, True)
    ref = factory("worker")
    for lo in range(0, upto + 4, CHUNK):
        hi = min(lo + CHUNK, upto + 4)
        ref_tok = ref.prefill_chunk(0, prompt[lo:hi], lo, hi == upto + 4)
    _close(dst.last_logits, ref.last_logits)
    assert tok == ref_tok


@pytest.mark.parametrize("s_kv", [64, 44])
def test_slot_padding_wrap_matches_jax(setup, s_kv):
    """A 32-token chunk, then 8 tokens, which the JAX package pads to 16.
    At ``s_kv = 64`` nothing wraps and the port matches the JAX executor.
    At ``s_kv = 44`` the reference's padded tokens would wrap onto
    positions 0-3, which stay marked valid (ROADMAP.md section 3); the
    port writes only the real tokens, so it matches its own run at a wide
    ``s_kv`` where nothing can wrap."""
    prompt = np.random.default_rng(0).integers(
        0, setup.cfg.vocab_size, 40).astype(np.int32)
    ref = (_JaxSlot(setup.jmodel, setup.jparams, max_slots=1, s_kv=s_kv)
           if s_kv == 64 else RealExecutor(setup.model, max_slots=1,
                                           s_kv=128))
    out = []
    for ex in (RealExecutor(setup.model, max_slots=1, s_kv=s_kv), ref):
        ex.prefill_chunk(0, prompt[:32], 0, False)
        out.append((ex.prefill_chunk(0, prompt[32:], 32, True),
                    np.asarray(ex.last_logits, np.float32)))
    (tok, logits), (rtok, rlogits) = out
    _close(logits, rlogits, LOGIT_TOL)
    assert tok == rtok
