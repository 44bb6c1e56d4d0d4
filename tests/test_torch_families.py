"""The dense families of the registry on both of the port's executors,
against the JAX package's.

Smoke variants that keep each family's attention flavour, on the CPU in
fp32 with TF32 off:

  * qwen2-7b at ``n_heads=14, n_kv_heads=2`` (G = 7, as at full width);
  * starcoder2-15b at ``n_heads=24, n_kv_heads=2`` (G = 12);
  * qwen3-32b with qk-norm;
  * gemma3-27b with qk-norm and sliding windows (smoke window 64, every
    2nd layer global), prompts up to 81 tokens so the window masks;
  * qwen2-vl-72b with M-RoPE ``(16, 8, 8)`` on text-only token prompts.

Weights are drawn by JAX from PRNGKey(0), their norm weights moved off
zero by numpy draws (so qk-norm's ``1 + w`` is exercised), and bridged
over. Cronus serves the same five prompts under max-throughput and
staggered arrivals: torch paged against JAX paged for the three families
the paged executor takes, torch slot against JAX slot for all five. The
Balancer's splits are equal, logits agree within ``LOGIT_TOL`` at every
step, and a token may differ only where the top two logits lie within
``GREEDY_TIE_MARGIN`` (plus the logit difference); the request's stream
is compared no further after such a step. Each family compiles its JAX
forwards once for the whole module.
"""
import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.executor import PagedRealExecutor as JaxPagedExecutor
from repro.core.executor import RealExecutor as JaxRealExecutor
from repro.core.request import Request as JaxRequest
from repro.models import build_model
from repro.serving import hardware as jax_hw
from repro.serving.simulator import build_system as jax_build_system
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.executor import (GREEDY_TIE_MARGIN, PagedRealExecutor,
                                       RealExecutor)
from repro_torch.core.request import Request
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import NORM_KEYS, DecoderModel
from repro_torch.serving import hardware
from repro_torch.serving.api import (paged_executor_factory,
                                     slot_executor_factory)
from repro_torch.serving.simulator import build_system

S_KV, SLOTS, CHUNK, BLOCK = 128, 4, 16, 4
NBLK = SLOTS * (S_KV // BLOCK)
LENS = [(17, 5), (81, 6), (9, 4), (41, 6), (25, 3)]
# fp32 logits of two frameworks / two layouts differ by ~1e-6
LOGIT_TOL = 1e-4

# family -> smoke overrides that keep its full-width GQA ratio
FAMILIES = {
    "qwen2-7b": dict(n_heads=14, n_kv_heads=2),
    "starcoder2-15b": dict(n_heads=24, n_kv_heads=2),
    "qwen3-32b": {},
    "gemma3-27b": {},
    "qwen2-vl-72b": {},
    "deepseek-v2-236b": {},
    "kimi-k2-1t-a32b": {},
}
PAGED = ["qwen2-7b", "starcoder2-15b", "qwen3-32b"]
SLOT_ONLY = ["gemma3-27b", "qwen2-vl-72b"]
# MoE families (tests/test_torch_moe.py, test_torch_mla.py): slot only too
MOE = ["deepseek-v2-236b", "kimi-k2-1t-a32b"]


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


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """One family's configs, weights, models and shared JAX forwards,
    built once for the module."""
    over = FAMILIES[arch]
    cfg = smoke_variant(get_config(arch), **over)
    jcfg = jax_smoke_variant(jax_get_config(arch), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = build_model(jcfg, exact_moe=True)
    tree = _perturb_norms(jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0))), np.random.default_rng(1))
    jparams = jax.tree.map(jax.numpy.asarray, tree)
    model = DecoderModel(cfg, params_from_numpy(tree, cfg, device="cpu"),
                         device="cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _ in LENS]
    return types.SimpleNamespace(cfg=cfg, jcfg=jcfg, jmodel=jmodel,
                                 jparams=jparams, model=model,
                                 prompts=prompts, slot_fwd=None,
                                 paged_fns={})


class _JaxSlot(JaxRealExecutor):
    """The JAX slot executor on the family's one jitted forward, keeping
    the logits rows it picks from."""

    def __init__(self, fam, *a, **kw):
        super().__init__(fam.jmodel, fam.jparams, *a, **kw)
        if fam.slot_fwd is None:
            fam.slot_fwd = self._fwd
        self._fwd = fam.slot_fwd
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


class _JaxPaged(JaxPagedExecutor):
    """The JAX paged executor on the family's jitted forwards (one set per
    page size), keeping the logits rows it picks from."""

    def __init__(self, fam):
        self._fam = fam
        super().__init__(fam.jmodel, fam.jparams)
        self.last_logits = None

    def _build_fns(self):
        key = (self.page, self.use_pallas)
        fns = self._fam.paged_fns
        if key not in fns:
            super()._build_fns()
            fns[key] = (self._prefill_fn, self._decode_fn, self._cow_fn,
                        self._inject_fn)
        prefill, decode, self._cow_fn, self._inject_fn = fns[key]

        def keep(fn):
            def run(*a):
                logits, k, v = fn(*a)
                self._logits = np.asarray(logits, np.float32)
                return logits, k, v
            return run
        self._prefill_fn, self._decode_fn = keep(prefill), keep(decode)

    def prefill_chunk(self, slot, tokens, ctx_len, completes, enc_emb=None):
        tok = super().prefill_chunk(slot, tokens, ctx_len, completes,
                                    enc_emb)
        if completes:
            self.last_logits = self._logits[0, len(tokens) - 1][None]
        return tok

    def decode(self, slot_tokens, slot_lens):
        out = super().decode(slot_tokens, slot_lens)
        self.last_logits = self._logits[:len(slot_tokens)]
        return out


def _recording(ex, slots_of):
    """Wrap an executor so that every emitted token keeps its logits row:
    ``rows[(req_id, index)] = (logits, token)``."""
    rows = {}
    prefill, decode = ex.prefill_chunk, ex.decode

    def req(slot):
        r = slots_of()[slot]
        return r.req_id, len(r.generated)

    def prefill_chunk(slot, tokens, ctx_len, completes, enc_emb=None):
        tok = prefill(slot, tokens, ctx_len, completes, enc_emb)
        if completes:
            rows[req(slot)] = (np.array(ex.last_logits[0]), tok)
        return tok

    def decode_(slot_tokens, slot_lens):
        out = decode(slot_tokens, slot_lens)
        for i, s in enumerate(sorted(slot_tokens)):
            rows[req(s)] = (np.array(ex.last_logits[i]), out[s])
        return out
    ex.prefill_chunk, ex.decode = prefill_chunk, decode_
    return rows


def _reqs(cls, prompts, staggered):
    reqs = [cls(req_id=f"r{i}", prompt=prompts[i].copy(),
                output_len=LENS[i][1], arrival=0.0)
            for i in range(len(LENS))]
    if staggered:
        for i, r in enumerate(reqs):
            r.arrival = i * 0.5
            r.metrics.arrival = r.arrival
    return reqs


def _serve(kind, fam, staggered):
    """Cronus over the 5-request trace on one executor kind ("jax-slot",
    "jax-paged", "slot", "paged"); returns {(req, i): (logits, token)}
    and each request's Balancer split."""
    executor = "paged" if kind.endswith("paged") else "real"
    if kind == "jax-slot":
        def factory(role):
            return _JaxSlot(fam, max_slots=2 if role == "ppi" else SLOTS,
                            s_kv=S_KV, chunk_pad=CHUNK)
    elif kind == "jax-paged":
        def factory(role):
            return _JaxPaged(fam)
    elif kind == "slot":
        factory = slot_executor_factory(fam.cfg, fam.model, device="cpu",
                                        max_slots=SLOTS, s_kv=S_KV,
                                        chunk_pad=CHUNK)
    else:
        factory = paged_executor_factory(fam.cfg, fam.model, device="cpu")
    if kind.startswith("jax"):
        system = jax_build_system(
            "cronus", fam.jcfg, jax_hw.A100, jax_hw.A30,
            executor_factory=factory, max_slots=SLOTS, block_size=BLOCK,
            max_batched_tokens=CHUNK, num_kv_blocks=NBLK, executor=executor)
        reqs = _reqs(JaxRequest, fam.prompts, staggered)
    else:
        system = build_system(
            "cronus", fam.cfg, hardware.A100, hardware.A30,
            executor_factory=factory, max_slots=SLOTS, block_size=BLOCK,
            max_batched_tokens=CHUNK, num_kv_blocks=NBLK, executor=executor)
        reqs = _reqs(Request, fam.prompts, staggered)
    recorded = [_recording(e.executor, lambda e=e: e.slots)
                for e in (system.ppi, system.cpi)]
    res = system.run(reqs)
    assert res["completed"] == len(LENS)
    merged = {}
    for r in recorded:
        merged.update(r)
    return merged, {r.req_id: r.partial_len for r in reqs}


def _compare(got, want):
    """Logits within LOGIT_TOL at every compared step; a token differs
    only at a near-tie, and the request is compared no further."""
    assert set(got) == set(want)
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


STAGGER = [False, True]
STAGGER_IDS = ["maxtput", "staggered"]


@pytest.mark.parametrize("staggered", STAGGER, ids=STAGGER_IDS)
@pytest.mark.parametrize("arch", PAGED)
def test_paged_matches_jax_paged(arch, staggered):
    fam = _setup(arch)
    got, parts = _serve("paged", fam, staggered)
    want, want_parts = _serve("jax-paged", fam, staggered)
    assert parts == want_parts
    _compare(got, want)
    if not staggered:
        # the PPI really split a prompt and handed its pages over
        assert any(0 < parts[f"r{i}"] < n for i, (n, _) in enumerate(LENS))


@pytest.mark.parametrize("staggered", STAGGER, ids=STAGGER_IDS)
@pytest.mark.parametrize("arch", PAGED + SLOT_ONLY)
def test_slot_matches_jax_slot(arch, staggered):
    fam = _setup(arch)
    got, parts = _serve("slot", fam, staggered)
    want, want_parts = _serve("jax-slot", fam, staggered)
    assert parts == want_parts
    _compare(got, want)


@pytest.mark.parametrize("arch", SLOT_ONLY + MOE)
def test_paged_executor_refuses_as_jax(arch):
    """Windows, embedding input and MoE stacks (with their dense first
    layers and MLA) keep the paged executor out, in both packages, with
    the same message."""
    fam = _setup(arch)
    with pytest.raises(NotImplementedError) as got:
        PagedRealExecutor(fam.model)
    with pytest.raises(NotImplementedError) as want:
        JaxPagedExecutor(fam.jmodel, fam.jparams)
    assert str(got.value) == str(want.value)


def test_window_masks_in_the_slot_forward():
    """gemma3's local layer really masks at these prompt lengths: the
    last logits of an 81-token prompt change when every window is cut to
    0 (full attention) on the same weights."""
    fam = _setup("gemma3-27b")
    assert [fam.cfg.layer_window(i) for i in range(fam.cfg.n_layers)] == \
        [64, 0]
    prompt = fam.prompts[1][:81]
    out = []
    for cfg in (fam.cfg, dataclasses.replace(fam.cfg, window_size=0)):
        model = DecoderModel(cfg, fam.model.params, device="cpu")
        ex = RealExecutor(model, max_slots=1, s_kv=S_KV)
        for lo in range(0, 81, 32):
            ex.prefill_chunk(0, prompt[lo:lo + 32], lo, lo + 32 >= 81)
        out.append(ex.last_logits)
    assert np.abs(out[0] - out[1]).max() > 1e-3
