"""The harness's whole run at smoke size on the CPU (plain attention in
place of the CUDA kernels), and the comparison that decides ``correct``:
it passes a sound run and fails a perturbed output and each fault the
served cells can have, planted under the timed path."""
import json
import time

import numpy as np
import pytest

import check
import harness
import weights
from conftest import smoke_cell

OPEN = "qwen2-7b.conv-poisson"
CLOSED = "decode-closed"       # the closed loop's mix, run on the same cell


def _run(loop, trace=False, fault=None, seed=2 ** 31 + 5):
    cell = smoke_cell(OPEN, mix=None if loop == OPEN else loop)
    return harness.run_cell(cell, seed, 2.5, trace, device="cpu",
                            process_start=time.perf_counter(),
                            use_kernels=False, fault=fault)


@pytest.mark.parametrize("loop,trace", [(OPEN, False), (OPEN, True),
                                        (CLOSED, False), (CLOSED, True)])
def test_sound_run_is_correct_and_reports_its_metrics(loop, trace):
    out = _run(loop, trace)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert list(out)[-1] == "checks"
    cell = harness.load_cell(OPEN)
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    device_only = {m["name"] for m in cell.per_layer
                   if m["source"] == "device_trace"}
    # the CPU has no device trace: those readers find nothing to read
    assert set(out["metrics"]) == names - (device_only if trace else set())
    for m in out["metrics"].values():
        assert np.isfinite(m["value"]) and m["value"] > 0
    gap = out["checks"]["logit_gap_max"]
    assert 0 <= gap["value"] <= gap["limit"]
    assert out["info"]["tokens_checked"] > 0
    json.dumps(out)


def test_comparison_fails_a_perturbed_output():
    cell = smoke_cell(OPEN)
    dims = harness.model_dims(cell.config)
    params = weights.make_params(dims, 7, "cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, dims["vocab"], 40).astype(np.int32)
    # greedy tokens of the reference itself read a gap of 0
    tokens, seq = [], list(prompt)
    import torch
    import reference
    for _ in range(6):
        logits = reference.served_logits(
            params, dims, [torch.tensor(seq)], [len(seq)])[0]
        tokens.append(int(logits[-1].argmax()))
        seq.append(tokens[-1])
    sound = check.served_gap(reference.served_logits, params, dims,
                             [(prompt, tokens)], "cpu")
    assert sound["gap_max"] == 0.0 and sound["tokens"] == 6
    bad = list(tokens)
    bad[3] = (bad[3] + 1) % dims["vocab"]
    broken = check.served_gap(reference.served_logits, params, dims,
                              [(prompt, bad)], "cpu")
    limit = cell.limits["logit_gap_max"]["limit"]
    assert broken["gap_max"] > limit


def _token_altered(service):
    ex = service.system.cpi.executor
    inner = ex.decode

    def decode(slot_tokens, slot_lens):
        out = inner(slot_tokens, slot_lens)
        first = min(out)
        out[first] = (out[first] + 1) % service.cfg.vocab_size
        return out
    ex.decode = decode


def _state_unchanged(service):
    # the CPI's steps leave its KV pool as it was
    service.system.cpi.executor._write = lambda pool, rows, idx: None


def _handoff_left_out(service):
    service.system.cpi.executor.inject_kv = lambda slot, payload, upto: None


def _half_batch_left_out(service):
    ex = service.system.cpi.executor
    inner = ex.decode

    def decode(slot_tokens, slot_lens):
        slots = sorted(slot_tokens)
        keep = slots[:max(1, len(slots) // 2)]
        out = inner({s: slot_tokens[s] for s in keep},
                    {s: slot_lens[s] for s in keep})
        for i, s in enumerate(slots[len(keep):]):
            out[s] = out[keep[i % len(keep)]]
        return out
    ex.decode = decode


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _handoff_left_out, _half_batch_left_out])
def test_each_fault_of_the_timed_path_reads_incorrect(fault):
    out = _run(CLOSED if fault is _half_batch_left_out else OPEN,
               fault=fault)
    assert out["correct"] is False
    assert out["checks"]["logit_gap_max"]["value"] > \
        out["checks"]["logit_gap_max"]["limit"]


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12, 2 ** 32 + 13])
def test_control_reads_above_the_limit(seed):
    """The control (the reference in fp8 e4m3 put in the program's place)
    fails the cell's limit at smoke widths and 12 layers, on 400
    positions of four prompts (fp8's rounding grows with depth and the
    widest gap with the positions read: these read 1.46-2.20 on the CPU,
    the cell's 28 layers 2.28-3.49 on the card)."""
    cell = smoke_cell(OPEN, 12)
    dims = harness.model_dims(cell.config)
    params = weights.make_params(dims, seed, "cpu")
    rng = np.random.default_rng(seed)
    picked = [(rng.integers(0, dims["vocab"], 60).astype(np.int32),
               list(rng.integers(0, dims["vocab"], 100))) for _ in range(4)]
    out = check.served_gap(cell.reference.served_logits, params, dims, picked,
                           "cpu", control=True)
    assert out["tokens"] == 400
    assert out["control_gap_max"] > cell.limits["logit_gap_max"]["limit"]


def test_tokens_served_count_the_prefill_chunks_and_kv_peaks():
    out = _run(OPEN)
    info = out["info"]
    assert info["n_prompt_tokens"] > 0
    assert info["tokens_per_s"] == pytest.approx(
        (info["n_prompt_tokens"] + info["n_tokens"]) / 2.5)
    kv = info["kv_blocks"]
    assert set(kv) == {"pool", "ppi", "cpi"}
    for reserved, live in (kv["ppi"], kv["cpi"]):
        assert 0 <= live <= reserved <= kv["pool"]
    # a smoke prompt is one chunk, so the PPI may hold none between steps
    assert kv["cpi"][1] > 0


def test_ppi_share_counts_every_served_request_split_or_not():
    from types import SimpleNamespace as NS
    reqs = [NS(req_id="a", partial_len=50, input_len=100),
            NS(req_id="b", partial_len=0, input_len=100),
            NS(req_id="c", partial_len=0, input_len=100),    # no token
            NS(req_id="d", partial_len=10, input_len=10)]    # due earlier
    sent = [harness.Sent(r, due, due) for r, due in
            zip(reqs, (1.0, 2.0, 3.0, -1.0))]
    rec = harness.Record(tokens={"a": [1.5], "b": [2.5], "d": [0.5]})
    run = harness.Run({}, sent, 0.0, 10.0, rec, None)
    assert harness.reader("ppi_token_share.lat")(run) == pytest.approx(25.0)
    rec.tokens.clear()
    assert harness.reader("ppi_token_share.lat")(run) is None


def test_tbt_tail_reader_reads_the_window_gaps_as_end_to_end_does():
    sent = []
    # gaps of 10, 20 and 40 ms end in the window; the 1 s gap ends before it
    rec = harness.Record(tokens={"a": [0.0, 1.0, 1.01, 1.03],
                                 "b": [1.5, 1.54], "c": [0.2]})
    run = harness.Run({}, sent, 1.005, 10.0, rec, None)
    e2e = harness.end_to_end(sent, rec, 1.005, 10.0)
    tail = harness.reader("tbt_p99_ms.lat")(run)
    assert tail == pytest.approx(e2e["tbt_p99_ms"])
    assert 39.0 < tail < 40.0 and e2e["tbt_p50_ms"] == pytest.approx(20.0)
    rec.tokens = {"a": [0.0, 0.1]}
    assert harness.reader("tbt_p99_ms.lat")(run) is None
