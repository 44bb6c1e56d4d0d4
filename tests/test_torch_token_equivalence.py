"""The port's run of ``tests/helpers/check_token_equivalence.py``:
Cronus, disaggregated L-H and DP serving on the slot executor against a
monolithic chunked-serving oracle (one executor, one request at a time),
on the CPU in fp32, at the helper's sizes; then an MoE (kimi-k2, the
split pinned to 16 tokens) and an SSM (mamba2) model through Cronus.

The helper asks for bit-equal tokens in a fresh process. Eager PyTorch
is not bit-identical across batch shapes, so here every emitted token's
logits row must lie within 1e-4 of the oracle's, and the tokens must be
equal wherever the oracle's greedy pick clears ``robust_greedy``'s 0.05
margin: a request whose tokens part at a near-tie is compared no
further.
"""
import functools
import types

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core.balancer import Balancer
from repro_torch.core.baselines import build_dp
from repro_torch.core.cronus import build_cronus, build_disaggregated
from repro_torch.core.executor import GREEDY_TIE_MARGIN, RealExecutor
from repro_torch.core.predictor import profile_chunked, profile_prefill
from repro_torch.core.request import Request
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving.hardware import A30, A100, DeviceModel

S_KV, SLOTS, CHUNK = 128, 4, 16
LENS = [(17, 5), (33, 8), (9, 4), (41, 6), (25, 3)]
LOGIT_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """The smoke model with JAX's weights from PRNGKey(0)."""
    cfg = get_config(arch, smoke=True)
    jmodel = jax_build_model(jax_get_config(arch, smoke=True),
                             exact_moe=True)
    tree = jax.tree.map(np.asarray,
                        jmodel.init_params(jax.random.PRNGKey(0)))
    model = build_model(cfg, params_from_numpy(tree, cfg, device="cpu"),
                        device="cpu", exact_moe=True)
    return cfg, model


def _executor(model):
    return RealExecutor(model, max_slots=SLOTS, s_kv=S_KV, chunk_pad=CHUNK)


def _oracle(model, prompt, out_len):
    """One request alone, chunk by chunk: ``{index: (logits, token)}``."""
    ex = _executor(model)
    rows, first, n = {}, None, len(prompt)
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        first = ex.prefill_chunk(0, prompt[lo:hi], lo, hi == n)
    rows[0] = (ex.last_logits[0].copy(), first)
    for t in range(out_len - 1):
        tok = ex.decode({0: rows[t][1]}, {0: n + t})[0]
        rows[t + 1] = (ex.last_logits[0].copy(), tok)
    return rows


def _recording(ex, slots, rows):
    """Keep every emitted token's logits row: ``rows[(req_id, index)]``."""
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


def _serve(system, engines, prompts, out_lens):
    rows = {}
    for e in engines:
        _recording(e.executor, e.slots, rows)
    reqs = [Request(req_id=f"r{i}", prompt=p.copy(), output_len=n)
            for i, (p, n) in enumerate(zip(prompts, out_lens))]
    system.run(reqs)
    return rows, {r.req_id: r for r in reqs}


def _compare(got, want):
    """Every compared row within LOGIT_TOL of the oracle's; tokens equal
    unless the oracle's pick is a near-tie, after which the request is
    compared no further. Returns the number of near-tie partings."""
    ties = 0
    for rid, steps in want.items():
        for i in sorted(steps):
            (la, ta), (lb, tb) = got[(rid, i)], steps[i]
            assert float(np.abs(la - lb).max()) <= LOGIT_TOL, (rid, i)
            if ta == tb:
                continue
            top2 = np.sort(lb)[-2:]
            assert top2[1] - top2[0] < GREEDY_TIE_MARGIN + LOGIT_TOL, \
                (rid, i, ta, tb)
            ties += 1
            break
    return ties


def _llama():
    cfg, model = _setup("llama3-8b")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _ in LENS]
    out_lens = [n for _, n in LENS]
    want = {f"r{i}": _oracle(model, p, n)
            for i, (p, n) in enumerate(zip(prompts, out_lens))}
    hi, lo = DeviceModel(A100, cfg), DeviceModel(A30, cfg)
    return types.SimpleNamespace(cfg=cfg, model=model, prompts=prompts,
                                 out_lens=out_lens, want=want, hi=hi, lo=lo)


@functools.lru_cache(maxsize=None)
def _llama_setup():
    return _llama()


def test_cronus_matches_the_oracle():
    s = _llama_setup()
    bal = Balancer(profile_prefill(s.lo), profile_chunked(s.hi))
    system = build_cronus(s.cfg, s.lo, s.hi,
                          executor_factory=lambda role: _executor(s.model),
                          balancer=bal, max_batched_tokens=16,
                          max_slots=SLOTS, block_size=4)
    rows, reqs = _serve(system, [system.ppi, system.cpi], s.prompts,
                        s.out_lens)
    assert len(system.cpi.finished) == len(LENS)
    for r in reqs.values():
        assert 1 <= r.partial_len <= r.input_len
    # the balancer really split a prompt between the two engines
    assert any(r.partial_len < r.input_len for r in reqs.values())
    _compare(rows, s.want)


def test_disaggregated_lh_matches_the_oracle():
    s = _llama_setup()
    system = build_disaggregated(
        s.cfg, s.lo, s.hi, executor_factory=lambda role: _executor(s.model),
        max_batched_tokens=16, max_slots=SLOTS, block_size=4)
    rows, reqs = _serve(system, [system.ppi, system.cpi], s.prompts,
                        s.out_lens)
    assert len(system.cpi.finished) == len(LENS)
    for r in reqs.values():
        assert r.partial_len == r.input_len
    _compare(rows, s.want)


def test_dp_matches_the_oracle():
    s = _llama_setup()
    system = build_dp(s.cfg, s.hi, s.lo,
                      executor_factory=lambda role: _executor(s.model),
                      max_slots=SLOTS, block_size=4)
    rows, _ = _serve(system, system.engines, s.prompts, s.out_lens)
    assert sum(len(e.finished) for e in system.engines) == len(LENS)
    _compare(rows, s.want)


class _Lp16:
    """The MoE run's split, pinned at 16 tokens (a chunk boundary)."""

    def partial_prefill_length(self, l_in, stats):
        return min(16, l_in)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "mamba2-780m"])
def test_moe_and_ssm_through_cronus_match_the_oracle(arch):
    cfg, model = _setup(arch)
    n_reqs = 1 if arch.startswith("kimi") else 2
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (19, 27)][:n_reqs]
    want = {f"r{i}": _oracle(model, p, 4) for i, p in enumerate(prompts)}
    hi, lo = DeviceModel(A100, cfg), DeviceModel(A30, cfg)
    bal = (_Lp16() if arch.startswith("kimi")
           else Balancer(profile_prefill(lo), profile_chunked(hi)))
    system = build_cronus(cfg, lo, hi,
                          executor_factory=lambda role: _executor(model),
                          balancer=bal, max_batched_tokens=16,
                          max_slots=SLOTS, block_size=4)
    rows, reqs = _serve(system, [system.ppi, system.cpi], prompts,
                        [4] * n_reqs)
    assert len(system.cpi.finished) == n_reqs
    if arch.startswith("kimi"):
        assert all(r.partial_len == 16 for r in reqs.values())
    _compare(rows, want)
