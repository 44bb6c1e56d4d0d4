"""The port's main path against the JAX package's: Cronus PPI->CPI serving
over the paged KV pool, on the CPU with the plain attention versions.

The same llama3-8b smoke weights (drawn by JAX from PRNGKey(0), bridged
over as numpy) and the same prompts go through the JAX
``PagedRealExecutor`` and the port's. Paged is compared with paged, never
with the slot executor. Tokens and the Balancer's ``partial_len`` must be
equal: both executors pick with ``robust_greedy`` (margin 0.05), and the
two frameworks' fp32 logits differ by ~1e-6, far inside that margin.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.executor import PagedRealExecutor as JaxPagedExecutor
from repro.core.request import Request as JaxRequest
from repro.models import build_model
from repro.serving import hardware as jax_hw
from repro.serving.simulator import build_system as jax_build_system
from repro.serving.trace import make_trace
from repro_torch.configs import get_config
from repro_torch.core.engine import EngineConfig
from repro_torch.core.executor import PagedRealExecutor
from repro_torch.core.request import Request
from repro_torch.kvcache.allocator import BlockAllocator
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import hardware
from repro_torch.serving.api import paged_executor_factory
from repro_torch.serving.simulator import APPROACHES, build_system

# the sizes of tests/test_paged_executor.py
S_KV, SLOTS, CHUNK, BLOCK = 128, 4, 16, 4
NBLK = SLOTS * (S_KV // BLOCK)
LENS = [(17, 5), (33, 8), (9, 4), (41, 6), (25, 3)]


@pytest.fixture(scope="module")
def setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jcfg = jax_get_config("llama3-8b", smoke=True)
    jmodel = build_model(jcfg, exact_moe=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = get_config("llama3-8b", smoke=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _ in LENS]
    return types.SimpleNamespace(jcfg=jcfg, jmodel=jmodel, jparams=jparams,
                                 cfg=cfg, params=params, prompts=prompts)


class _JaxPaged(JaxPagedExecutor):
    """The JAX paged executor with its jitted forwards built once per page
    size and shared between instances: they close over the model and the
    page size only, and compiling them anew for every engine of every run
    would take most of this file's time."""

    _shared = {}

    def _build_fns(self):
        key = (id(self.model), self.page, self.use_pallas)
        if key not in self._shared:
            super()._build_fns()
            self._shared[key] = (self._prefill_fn, self._decode_fn,
                                 self._cow_fn, self._inject_fn)
        (self._prefill_fn, self._decode_fn, self._cow_fn,
         self._inject_fn) = self._shared[key]


def _reqs(cls, prompts, staggered):
    reqs = [cls(req_id=f"r{i}", prompt=prompts[i].copy(),
                output_len=LENS[i][1], arrival=0.0)
            for i in range(len(LENS))]
    if staggered:
        for i, r in enumerate(reqs):
            r.arrival = i * 0.5
            r.metrics.arrival = r.arrival
    return reqs


def _engines(system):
    if hasattr(system, "engines"):               # DPSystem
        return system.engines
    if hasattr(system, "engine"):                # PPSystem
        return [system.engine]
    return [system.ppi, system.cpi]              # CronusSystem


def _collect(system, n):
    toks, parts = {}, {}
    for e in _engines(system):
        for r in e.finished:
            toks.setdefault(r.req_id, list(r.generated))
            parts.setdefault(r.req_id, r.partial_len)
    assert len(toks) == n
    return toks, parts


def _run_jax(s, approach, staggered):
    system = jax_build_system(
        approach, s.jcfg, jax_hw.A100, jax_hw.A30,
        executor_factory=lambda role: _JaxPaged(s.jmodel, s.jparams),
        max_slots=SLOTS, block_size=BLOCK, max_batched_tokens=CHUNK,
        num_kv_blocks=NBLK, executor="paged")
    res = system.run(_reqs(JaxRequest, s.prompts, staggered))
    assert res["completed"] == len(LENS)
    return _collect(system, len(LENS))


def _run_torch(s, approach, staggered, **kw):
    system = build_system(
        approach, s.cfg, hardware.A100, hardware.A30,
        executor_factory=paged_executor_factory(s.cfg, params=s.params,
                                                device="cpu"),
        max_slots=SLOTS, block_size=BLOCK, max_batched_tokens=CHUNK,
        num_kv_blocks=NBLK, executor="paged", **kw)
    res = system.run(_reqs(Request, s.prompts, staggered))
    assert res["completed"] == len(LENS)
    return system, _collect(system, len(LENS))


@pytest.mark.parametrize("staggered", [False, True],
                         ids=["maxtput", "staggered"])
@pytest.mark.parametrize("approach", APPROACHES)
def test_paged_tokens_match_jax_paged(setup, approach, staggered):
    """Same tokens and the same Balancer splits as the JAX paged
    executor, on every ported approach x arrival pattern."""
    want_toks, want_parts = _run_jax(setup, approach, staggered)
    _, (toks, parts) = _run_torch(setup, approach, staggered)
    assert parts == want_parts
    assert toks == want_toks
    if approach == "cronus" and not staggered:
        # the PPI really split a prompt and handed its pages over
        assert any(0 < parts[f"r{i}"] < n for i, (n, _) in enumerate(LENS))


def _cache_reqs(vocab):
    rng = np.random.default_rng(7)
    # 26 % BLOCK != 0 so the cache hit shares a partial block -> CoW copy
    shared = rng.integers(0, vocab, 26).astype(np.int32)
    tails = [rng.integers(0, vocab, n).astype(np.int32) for n in (9, 13, 5)]
    return [Request(req_id=f"c{i}", prompt=np.concatenate([shared, t]),
                    output_len=6, arrival=float(i))
            for i, t in enumerate(tails)]


def test_prefix_cache_cow_matches_cold(setup):
    """Prefix-cache hits + CoW divergence on a cronus pair: the cached run
    reuses prompt tokens yet decodes the exact tokens of the cold run."""
    def run(prefix_cache):
        system = build_system(
            "cronus", setup.cfg, hardware.A100, hardware.A30,
            executor_factory=paged_executor_factory(
                setup.cfg, params=setup.params, device="cpu"),
            max_slots=SLOTS, block_size=BLOCK, max_batched_tokens=CHUNK,
            num_kv_blocks=NBLK, executor="paged", prefix_cache=prefix_cache)
        system.run(_cache_reqs(setup.cfg.vocab_size))
        fin = system.ppi.finished + system.cpi.finished
        toks = {r.req_id: list(r.generated) for r in system.cpi.finished}
        reused = sum(r.metrics.cached_prefix_tokens for r in fin)
        cows = sum(e.executor.compile_stats().get("cow", 0)
                   for e in (system.ppi, system.cpi))
        return toks, reused, cows

    cold, reused_cold, _ = run(False)
    warm, reused_warm, cows = run(True)
    assert len(cold) == 3
    assert reused_cold == 0
    assert reused_warm > 0
    assert cows > 0
    assert warm == cold


def _null_trace(cls, n):
    trace = make_trace(n, seed=3, arrival="poisson:8")
    return [cls(req_id=r.req_id, prompt=r.prompt.copy(),
                output_len=r.output_len, arrival=r.arrival) for r in trace]


@pytest.mark.parametrize("approach", APPROACHES)
def test_null_executor_aggregates_equal_jax(approach):
    """The copied control plane is the JAX package's: on a 200-request
    trace, the NullExecutor aggregates are equal, key for key."""
    jcfg = jax_get_config("llama3-8b")
    want = jax_build_system(approach, jcfg, jax_hw.A100, jax_hw.A10).run(
        _null_trace(JaxRequest, 200))
    got = build_system(approach, get_config("llama3-8b"), hardware.A100,
                       hardware.A10).run(_null_trace(Request, 200))
    assert got["completed"] == 200
    assert got == want


class _StubEngine:
    """The attributes attach_engine and the executor call sites read."""

    def __init__(self):
        self.ecfg = EngineConfig(max_batched_tokens=CHUNK, max_slots=SLOTS,
                                 block_size=BLOCK, num_kv_blocks=NBLK,
                                 executor="paged")
        self.allocator = BlockAllocator(NBLK, BLOCK)
        self.slots = [None] * SLOTS

    def place(self, slot, req_id, n_tokens):
        self.allocator.allocate(req_id, n_tokens)
        self.slots[slot] = types.SimpleNamespace(req_id=req_id)

    def free(self, slot):
        self.allocator.free(self.slots[slot].req_id)
        self.slots[slot] = None


def test_extract_kv_is_a_snapshot(setup):
    """extract_kv returns a copy: the PPI frees the request's blocks and
    reuses them for another prompt before the CPI injects the payload,
    and the CPI still gets the first request's K/V."""
    upto = 9
    factory = paged_executor_factory(setup.cfg, params=setup.params,
                                     device="cpu")
    src, dst = factory("ppi"), factory("cpi")
    se, de = _StubEngine(), _StubEngine()
    src.attach_engine(se)
    dst.attach_engine(de)
    se.place(0, "s0", upto)
    src.prefill_chunk(0, setup.prompts[0][:upto], 0, False)
    st = list(se.allocator.block_table("s0"))
    kv = setup.cfg.n_kv_heads, setup.cfg.head_dim
    src_rows = src.k_pool.reshape(src.model.n_stack, -1, *kv)
    want = torch.stack([src_rows[:, st[p // BLOCK] * BLOCK + p % BLOCK]
                        for p in range(upto)], 1).clone()
    payload = src.extract_kv(0, upto)

    se.free(0)                               # PPI reuses the same blocks
    se.place(1, "s1", upto)
    assert sorted(se.allocator.block_table("s1")) == sorted(st)
    src.prefill_chunk(1, setup.prompts[1][:upto], 0, False)
    assert not torch.equal(src_rows[:, st[0] * BLOCK], want[:, 0])

    de.place(2, "d0", upto)
    dst.inject_kv(2, payload, upto)
    dt = de.allocator.block_table("d0")
    dst_rows = dst.k_pool.reshape(dst.model.n_stack, -1, *kv)
    for p in range(upto):
        torch.testing.assert_close(
            dst_rows[:, dt[p // BLOCK] * BLOCK + p % BLOCK], want[:, p],
            rtol=0, atol=0)


def test_extract_inject_roundtrip_matches_jax(setup):
    """The PPI's pool rows after one prefill chunk equal the JAX paged
    executor's (fp32, 1e-5), and the payload is block-granular."""
    upto = 17
    px = PagedRealExecutor(
        paged_executor_factory(setup.cfg, params=setup.params,
                               device="cpu")("ppi").model)
    eng = _StubEngine()
    px.attach_engine(eng)
    eng.place(0, "p0", upto)
    jx = _JaxPaged(setup.jmodel, setup.jparams)
    jeng = types.SimpleNamespace(ecfg=eng.ecfg, slots=eng.slots,
                                 allocator=eng.allocator)
    jx.attach_engine(jeng)
    for lo in range(0, upto, CHUNK):
        hi = min(lo + CHUNK, upto)
        px.prefill_chunk(0, setup.prompts[0][lo:hi], lo, False)
        jx.prefill_chunk(0, setup.prompts[0][lo:hi], lo, False)
    pp = px.extract_kv(0, upto)
    n_pages = -(-upto // BLOCK)
    assert pp["_upto"] == upto and pp["_page"] == BLOCK
    assert tuple(pp["k_pages"].shape) == (px.model.n_stack, n_pages, BLOCK,
                                          setup.cfg.n_kv_heads,
                                          setup.cfg.head_dim)
    jp = jx.extract_kv(0, upto)
    for key in ("k_pages", "v_pages"):
        np.testing.assert_allclose(pp[key].numpy(), np.asarray(jp[key]),
                                   rtol=1e-5, atol=1e-5)


def test_host_tier_hit_token_identical(setup):
    """The host-tier hooks on real compute (the scenario of
    tests/test_kv_tiering.py::test_host_tier_hit_token_identical_paged, on
    one worker engine): r0 seeds the prefix cache, a filler's allocation
    pressure demotes the shared chain to pinned-or-host memory, and r1's
    hit promotes it back, decoding exactly the tokens of a cold run."""
    from repro_torch.cluster.router import RoundRobinRouter
    from repro_torch.cluster.runtime import ClusterRuntime, WorkerEndpoint
    from repro_torch.core.engine import Engine
    rng = np.random.default_rng(11)
    vocab = setup.cfg.vocab_size
    shared = rng.integers(0, vocab, 16).astype(np.int32)
    tail0, tail1, filler = (rng.integers(0, vocab, n).astype(np.int32)
                            for n in (5, 9, 33))

    def run(tiered):
        ecfg = EngineConfig(max_batched_tokens=CHUNK, max_slots=4,
                            block_size=BLOCK, num_kv_blocks=12,
                            prefix_cache=tiered,
                            host_kv_blocks=48 if tiered else 0,
                            executor="paged")
        ex = paged_executor_factory(setup.cfg, params=setup.params,
                                    device="cpu")("worker")
        eng = Engine("w0", setup.cfg, ecfg,
                     hardware.DeviceModel(hardware.A100, setup.cfg), ex)
        reqs = [Request(req_id="r0", prompt=np.concatenate([shared, tail0]),
                        output_len=6, arrival=0.0),
                Request(req_id="f0", prompt=filler.copy(), output_len=6,
                        arrival=5.0),
                Request(req_id="r1", prompt=np.concatenate([shared, tail1]),
                        output_len=6, arrival=10.0)]
        ClusterRuntime([WorkerEndpoint("w0", eng)], RoundRobinRouter()).run(
            reqs)
        toks = {r.req_id: list(r.generated) for r in eng.finished}
        assert len(toks) == 3
        return toks, eng.allocator, ex.compile_stats()

    cold, _, _ = run(False)
    warm, alloc, stats = run(True)
    assert alloc.n_demotions >= 4 and alloc.n_promotions >= 4
    assert "host_demote" in stats and "host_promote" in stats  # hooks ran
    assert warm == cold
