"""The paged executor's decode step replayed as a CUDA graph, one graph a
bucket ``(bb, pb)`` of lanes and table pages.

On the card (tests marked ``chip``, skipped where ``torch.cuda`` finds no
device) a qwen2-7b-shaped smoke model (28 query and 4 KV heads of 128, so
the kernel's G = 7, in fp32 with TF32 off) decodes 65 steps whose lanes go
3 -> 5 -> 9 -> 4 -> 3 and whose contexts cross three page buckets; each
step's graph is held to the same executor's eager forward at the same
bucket: greedy tokens identical, logits within 1e-2, and a narrower
step's replay writes no pool row but the trash page and its lanes' slots.
This file imports no JAX, so the card runs it without the repo's
conftest::

    PYTHONPATH=src python -m pytest --noconftest -q -s -m chip \\
        tests/test_torch_decode_graph.py

On the CPU, and with ``use_kernels=False``, decode never captures: its
spans say ``graph: "eager"`` and keep their four phases.
"""
import dataclasses
import math
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.engine import EngineConfig
from repro_torch.core.executor import robust_greedy
from repro_torch.core.request import Request
from repro_torch.kernels import paged_attention
from repro_torch.kvcache.allocator import BlockAllocator
from repro_torch.obs import host
from repro_torch.serving.api import ServeSpec, paged_executor_factory

PAGE, SLOTS, NBLK = 4, 16, 512
PROMPTS = [10 + i for i in range(9)]
LANES = [3] * 16 + [5] * 16 + [9] * 16 + [4] * 16 + [3]
PHASES = ["prep", "launch", "readback", "pick"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode graph replays the "
                    "CUDA kernels, which have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _StubEngine:
    """The attributes attach_engine and the executor call sites read."""

    def __init__(self, name="cpi"):
        self.name = name
        self.ecfg = EngineConfig(max_batched_tokens=64, max_slots=SLOTS,
                                 block_size=PAGE, num_kv_blocks=NBLK,
                                 executor="paged")
        self.allocator = BlockAllocator(NBLK, PAGE)
        self.slots = [None] * SLOTS

    def place(self, slot, req_id, n_tokens):
        self.allocator.allocate(req_id, n_tokens)
        self.slots[slot] = types.SimpleNamespace(req_id=req_id)


def _bucket(ex, slot_lens):
    pages = max(math.ceil((p + 1) / ex.page) for p in slot_lens.values())
    return (ex.buckets.bucket(len(slot_lens), lo=4),
            ex.buckets.bucket(pages, lo=4))


def _eager_logits(ex, slot_tokens, slot_lens):
    """The step through the executor's private eager forward at the same
    bucket, as ``decode`` runs it without the graph -> [n, V] fp32."""
    alloc = ex._alloc()
    slots = sorted(slot_tokens)
    bb, pb = _bucket(ex, slot_lens)
    tok = np.zeros((bb,), np.int64)
    pos = np.zeros((bb,), np.int32)
    widx = np.full((bb,), ex._trash * ex.page, np.int64)
    tbl = np.full((bb, pb), ex._trash, np.int32)
    ctx = np.zeros((bb,), np.int32)
    for i, s in enumerate(slots):
        table = alloc.block_table(ex._req_id(s))
        p = slot_lens[s]
        tok[i], pos[i], ctx[i] = slot_tokens[s], p, p + 1
        widx[i] = ex._flat_idx(table, p)
        tbl[i, :min(len(table), pb)] = table[:pb]
    with torch.no_grad():
        x = ex._decode_fwd(ex._tensor(tok, torch.long), ex._tensor(pos),
                           ex._tensor(widx, torch.long), ex._tensor(tbl),
                           ex._tensor(ctx))
        return ex._finish(x[:len(slots)]).float().cpu().numpy()


def _executors():
    cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True),
                              n_heads=28, n_kv_heads=4, head_dim=128,
                              d_model=512, d_ff=1024)
    factory = paged_executor_factory(cfg, device="cuda")
    return factory("cpi"), factory("cpi")


def _flat_rows(pool):
    return pool.reshape(pool.shape[0], -1, *pool.shape[3:])


@pytest.fixture(scope="module")
def served():
    """Both executors through the 65 steps: ``graphed`` replays, ``eager``
    runs the private forward; the narrow last step's pool check."""
    _card()
    graphed, eager = _executors()
    engines = [_StubEngine(), _StubEngine()]
    rng = np.random.default_rng(25)
    lens, last = {}, {}
    for ex, eng in zip((graphed, eager), engines):
        ex.attach_engine(eng)
    for s, n in enumerate(PROMPTS):
        prompt = rng.integers(0, graphed.cfg.vocab_size, n).astype(np.int32)
        for ex, eng in zip((graphed, eager), engines):
            eng.place(s, f"r{s}", n + len(LANES) + 1)
            first = ex.prefill_chunk(s, prompt, 0, True)
        lens[s], last[s] = n, first
    out = types.SimpleNamespace(mismatch=[], gap=0.0, pairs=set(),
                                steps=len(LANES), graphed=graphed,
                                engines=engines, launches=0)
    for t, n in enumerate(LANES):
        slot_tokens = {s: last[s] for s in range(n)}
        slot_lens = {s: lens[s] for s in range(n)}
        out.pairs.add(_bucket(graphed, slot_lens))
        if t == len(LANES) - 1:       # a 3-lane replay after 4-lane ones
            before = (_flat_rows(graphed.k_pool).clone(),
                      _flat_rows(graphed.v_pool).clone())
        launched = paged_attention.launches
        got = graphed.decode(slot_tokens, slot_lens)
        out.launches += paged_attention.launches - launched
        want = _eager_logits(eager, slot_tokens, slot_lens)
        out.gap = max(out.gap, float(np.abs(graphed.last_logits - want)
                                     .max()))
        for i, s in enumerate(sorted(slot_tokens)):
            if got[s] != robust_greedy(want[i]):
                out.mismatch.append((t, s, got[s], robust_greedy(want[i])))
            last[s], lens[s] = got[s], lens[s] + 1
    alloc = engines[0].allocator
    written = [graphed._flat_idx(alloc.block_table(f"r{s}"), lens[s] - 1)
               for s in range(LANES[-1])]
    keep = torch.ones(before[0].shape[1], dtype=torch.bool)
    keep[graphed._trash * PAGE:] = False
    keep[written] = False
    out.untouched = all(
        torch.equal(b[:, keep], _flat_rows(a)[:, keep])
        for b, a in zip(before, (graphed.k_pool, graphed.v_pool)))
    out.written_differ = not torch.equal(before[0][:, written],
                                         _flat_rows(graphed.k_pool)[:,
                                                                    written])
    out.kv_gap = max(float((_flat_rows(a)[:, :-PAGE] - _flat_rows(b)
                            [:, :-PAGE]).abs().max())
                     for a, b in ((graphed.k_pool, eager.k_pool),
                                  (graphed.v_pool, eager.v_pool)))
    print(f"\n[decode graph] {out.steps} steps, {len(out.pairs)} buckets "
          f"{sorted(out.pairs)}: largest logit difference to eager "
          f"{out.gap:.3e}, largest K/V difference {out.kv_gap:.3e}, "
          f"token mismatches {len(out.mismatch)}")
    return out


@pytest.mark.chip
def test_graph_tokens_equal_eager(served):
    assert served.mismatch == []


@pytest.mark.chip
def test_graph_logits_within_1e_2_of_eager(served):
    assert served.gap <= 1e-2
    assert served.kv_gap <= 1e-2


@pytest.mark.chip
def test_narrow_replay_writes_only_its_slots_and_trash(served):
    assert served.untouched
    assert served.written_differ


@pytest.mark.chip
def test_graph_counters_count(served):
    ex = served.graphed
    n_buckets = len(served.pairs)
    assert len(served.pairs) >= 6
    assert ex.graph_captures == n_buckets
    assert ex.graph_replays == served.steps - n_buckets
    # one launch a layer a step, and the warm-up of each capture
    assert served.launches == ex.model.n_stack * (served.steps + n_buckets)


@pytest.mark.chip
def test_attach_engine_drops_the_graphs(served):
    ex = served.graphed
    captures = ex.graph_captures
    eng = _StubEngine()
    ex.attach_engine(eng)
    eng.place(0, "again", 16)
    ex.prefill_chunk(0, np.arange(8, dtype=np.int32), 0, True)
    launched = paged_attention.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ex.decode({0: 1}, {0: 8})
        ex.decode({0: 2}, {0: 9})
    launched = paged_attention.launches - launched
    modes = [sp.args["graph"] for sp in host.session().spans
             if sp.name == "executor.decode"]
    assert modes == ["capture", "replay"]
    assert ex.graph_captures == captures + 1
    names = [ev.name() for ev in prof.profiler.kineto_results.events()
             if ev.device_type().name == "CUDA"]
    # the replayed kernels reach the device trace the benchmark reads, one
    # split kernel a counted launch: the capture's warm-up and the two
    # replays, a layer each
    assert sum("split_kernel<" in n for n in names) == launched \
        == 3 * ex.model.n_stack
    assert any("merge_kernel<" in n for n in names)


@pytest.mark.chip
def test_plain_attention_on_the_card_never_captures():
    _card()
    cfg = get_config("qwen2-7b", smoke=True)
    ex = paged_executor_factory(cfg, device="cuda", use_kernels=False)("cpi")
    eng = _StubEngine()
    ex.attach_engine(eng)
    eng.place(0, "p", 16)
    first = ex.prefill_chunk(0, np.arange(8, dtype=np.int32), 0, True)
    ex.decode({0: first}, {0: 8})
    assert ex.graph_captures == ex.graph_replays == 0


# ---------------------------------------------------------------------------
# the CPU: the eager forward, as before
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [None, False])
def test_cpu_decode_never_captures(use_kernels):
    cfg = get_config("qwen2-7b", smoke=True)
    ex = paged_executor_factory(cfg, device="cpu",
                                use_kernels=use_kernels)("cpi")
    eng = _StubEngine()
    ex.attach_engine(eng)
    last, lens = {}, {}
    for s in range(5):
        eng.place(s, f"r{s}", 40)
        lens[s] = 12 + s
        last[s] = ex.prefill_chunk(s, np.arange(lens[s], dtype=np.int32),
                                   0, True)
    with profile(activities=[ProfilerActivity.CPU]):
        for n in (3, 5, 2):
            got = ex.decode({s: last[s] for s in range(n)},
                            {s: lens[s] for s in range(n)})
            for s in got:
                last[s], lens[s] = got[s], lens[s] + 1
    decodes = [sp for sp in host.session().spans
               if sp.name == "executor.decode"]
    assert [sp.args["graph"] for sp in decodes] == ["eager"] * 3
    assert all([name for name, _, _ in sp.phases] == PHASES
               for sp in decodes)
    assert ex.graph_captures == ex.graph_replays == 0


def test_cpu_served_decodes_are_eager():
    service = ServeSpec(arch="qwen2-7b", smoke=True, approach="cronus",
                        executor="paged", max_slots=4, block_size=4,
                        max_batched_tokens=16, num_kv_blocks=128
                        ).build(device="cpu")
    rng = np.random.default_rng(7)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(3):
            service.submit(Request(f"c{i}", rng.integers(0, 256, 18 + 5 * i)
                                   .astype(np.int32), 5,
                                   arrival=service.now))
        while service.n_active:
            assert service.step()
    decodes = [sp for sp in host.session().spans
               if sp.name == "executor.decode"]
    assert decodes and {sp.args["engine"] for sp in decodes} == {"cpi"}
    for sp in decodes:
        assert sp.args["graph"] == "eager"
        assert [name for name, _, _ in sp.phases] == PHASES
    executors = [eng.executor for eng in service.runtime.engines]
    assert [(ex.graph_captures, ex.graph_replays) for ex in executors] \
        == [(0, 0)] * len(executors)
