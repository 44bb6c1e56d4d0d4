"""Model families: the harness reaches the model only through the family
module that a configuration names. The dense family gives bit for bit
what the harness's own functions give; a family planted as new files in
a copy of the benchmark serves and is checked against its own reference;
a family with no module is refused by name."""
import json
import shutil
import time

import numpy as np
import pytest
import torch

import check
import counts
import harness
import reference
import weights
from conftest import BENCH, HERE, ROOT, smoke_cell

OPEN = "qwen2-7b.conv-poisson"
SEED = 2 ** 31 + 21
PLANTED = HERE / "planted_family"
FAULT = '''
_sound_served_logits = served_logits


def served_logits(*args, **kwargs):
    """The sound logits shifted by one token id."""
    return [torch.roll(x, 1, -1) for x in _sound_served_logits(*args,
                                                               **kwargs)]
'''


def _picked(vocab, seed, n=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, 50).astype(np.int32),
             [int(t) for t in rng.integers(0, vocab, 20)]) for _ in range(n)]


@pytest.mark.parametrize("workload", [OPEN, "deepseek-coder-33b.code-poisson"])
def test_both_cells_are_of_the_dense_family(workload):
    cell = harness.load_cell(workload)
    assert "family" not in cell.config
    assert cell.family.__file__ == str(BENCH / "families" / "dense.py")
    assert cell.reference.__file__ == str(BENCH / "reference.py")


def test_dense_family_gives_the_direct_calls_bit_for_bit():
    cell = smoke_cell(OPEN)
    fam = cell.family
    dims = fam.dims(cell.config)
    assert dims == harness.model_dims(cell.config)
    assert fam.port_config(cell.config, dims) == harness.port_config(
        cell.config, dims)
    got = fam.make_params(dims, SEED, "cpu", torch.bfloat16)
    want = weights.make_params(dims, SEED, "cpu", torch.bfloat16)
    flat_got = dict(_leaves(got))
    flat_want = dict(_leaves(want))
    assert flat_got.keys() == flat_want.keys()
    for key, leaf in flat_want.items():
        assert flat_got[key].dtype == leaf.dtype, key
        assert torch.equal(flat_got[key], leaf), key
    seqs, starts, _ = check._inputs(_picked(dims["vocab"], SEED), "cpu")
    for quant in (None, "fp8"):
        a = cell.reference.served_logits(got, dims, seqs, starts, quant)
        b = reference.served_logits(want, dims, seqs, starts, quant)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), quant


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def test_dense_family_counts_each_step_as_the_direct_call():
    """Each ``service.step`` of a short CPU run adds to ``rec.step_flops``
    through the family exactly what ``counts.model_flops`` gives for the
    executor calls that the step made."""
    cell = smoke_cell(OPEN)
    fam = cell.family
    dims = fam.dims(cell.config)
    cfg = fam.port_config(cell.config, dims)
    params = fam.make_params(dims, SEED, "cpu", torch.bfloat16)
    service = harness.build_service(cfg, params, cell.config["serving"],
                                    "cpu", use_kernels=False)
    calls = []
    for eng in service.engines:
        ex = eng.executor

        def prefill_chunk(slot, tokens, ctx_len, completes, enc_emb=None,
                          _f=ex.prefill_chunk):
            calls.append(("prefill", len(tokens), int(ctx_len), completes))
            return _f(slot, tokens, ctx_len, completes, enc_emb=enc_emb)

        def decode(slot_tokens, slot_lens, _f=ex.decode):
            calls.append(("decode",
                          tuple(int(v) + 1 for v in slot_lens.values())))
            return _f(slot_tokens, slot_lens)
        ex.prefill_chunk, ex.decode = prefill_chunk, decode
    rec = harness.Record()
    harness._wrap_executors(service, rec, dims, lambda: None,
                            fam.model_flops)
    flops = dict(n_layers=dims["n_layers"], d=dims["d"], h=dims["h"],
                 kvh=dims["kvh"], hd=dims["hd"], d_ff=dims["d_ff"],
                 vocab=dims["vocab"])

    def direct(call):
        if call[0] == "prefill":
            _, c, ctx, completes = call
            return counts.model_flops(
                **flops, tokens=c, attn_pairs=counts.causal_pairs(ctx, c),
                head_rows=1 if completes else 0)
        lens = call[1]
        return counts.model_flops(**flops, tokens=len(lens),
                                  attn_pairs=sum(lens), head_rows=len(lens))

    from repro_torch.core.request import Request
    tr = harness.traffic_mod.Traffic(cell.mix, SEED, dims["vocab"])
    for i in range(6):
        n_in, out_len = tr.lengths()
        service.submit(Request(f"r{i}", tr.tokens(n_in), out_len,
                               arrival=service.now))
    steps = 0
    while service.n_active and steps < 500:
        calls.clear()
        rec.step_flops = 0
        service.step()
        assert rec.step_flops == sum(direct(c) for c in calls)
        steps += bool(calls)
    assert service.n_active == 0 and steps > 10


def _plant(root, executor):
    """A copy of ``BENCHMARK.json`` under ``root`` whose ``qwen2-7b``
    configuration names the planted family ``qk_norm`` (the registry's
    ``qwen3-32b``) on ``executor``, and the family's two files in
    ``root/perfbench/families``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    entry = next(c for c in bench["configs"] if c["name"] == "qwen2-7b")
    config = json.loads((ROOT / entry["file"]).read_text())
    config.update(family="qk_norm", arch="qwen3-32b")
    config["serving"] = dict(config["serving"], executor=executor)
    if executor == "real":
        config["serving"]["s_kv"] = 512
    (root / entry["file"]).parent.mkdir(parents=True)
    (root / entry["file"]).write_text(json.dumps(config))
    shutil.copytree(PLANTED, root / "perfbench" / "families",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def _run(cell, fault=None):
    return harness.run_cell(cell, SEED, 2.5, False, device="cpu",
                            process_start=time.perf_counter(),
                            use_kernels=False, fault=fault)


@pytest.mark.parametrize("executor", ["paged", "real"])
def test_planted_family_serves_and_is_checked_against_its_reference(
        tmp_path, executor):
    cell = smoke_cell(OPEN, root=_plant(tmp_path, executor))
    assert cell.family.__name__ == "perfbench_family_qk_norm"
    assert cell.config["hidden_size"] == cell.family.SMOKE["hidden_size"]
    built = []
    out = _run(cell, fault=lambda service: built.extend(
        type(e.executor).__name__ for e in service.engines))
    assert out["correct"] is True, out["checks"]
    assert out["info"]["tokens_checked"] > 0
    kind = {"paged": "PagedRealExecutor", "real": "RealExecutor"}[executor]
    assert built == [kind, kind]


def test_a_fault_in_the_planted_reference_reads_incorrect(tmp_path):
    root = _plant(tmp_path, "paged")
    ref = root / "perfbench" / "families" / "qk_norm_reference.py"
    ref.write_text(ref.read_text() + FAULT)
    out = _run(smoke_cell(OPEN, root=root))
    assert out["correct"] is False
    gap = out["checks"]["logit_gap_max"]
    assert gap["value"] > gap["limit"]


def test_the_planted_family_needs_its_own_reference(tmp_path):
    """The dense reference, which has no qk-norm, reads the planted
    family's greedy tokens above the limit: a check that ignored the
    family's reference would fail a sound run."""
    cell = smoke_cell(OPEN, root=_plant(tmp_path, "paged"))
    dims = cell.family.dims(cell.config)
    params = cell.family.make_params(dims, SEED, "cpu", torch.float32)
    picked = []
    for prompt, _ in _picked(dims["vocab"], SEED):
        seq = list(prompt)
        for _ in range(20):
            logits = cell.reference.served_logits(
                params, dims, [torch.tensor(seq)], [len(seq)])[0]
            seq.append(int(logits[-1].argmax()))
        picked.append((prompt, seq[len(prompt):]))
    own = check.served_gap(cell.reference.served_logits, params, dims,
                           picked, "cpu")
    dense = check.served_gap(reference.served_logits, params, dims, picked,
                             "cpu")
    limit = cell.limits["logit_gap_max"]["limit"]
    assert own["gap_max"] == 0.0
    assert dense["gap_max"] > limit


def test_a_family_with_no_module_is_refused_by_name(tmp_path):
    root = _plant(tmp_path, "paged")
    entry = next(c for c in json.loads((root / "BENCHMARK.json").read_text())
                 ["configs"] if c["name"] == "qwen2-7b")
    path = root / entry["file"]
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    family="no_such_family")))
    with pytest.raises(SystemExit, match="no_such_family.py"):
        harness.load_cell(OPEN, root)
