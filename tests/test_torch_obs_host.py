"""The port's host-clock spans (``repro_torch.obs.host``) on a smoke-size
Cronus pair of paged executors on the CPU: recorded only under a
``torch.profiler`` session, nested as the calls are, with ordered phases,
a request's ``req_id`` carried from the PPI to the CPI, a fresh buffer for
each session, and a clock anchor that lays them on the profiler's events.
"""
import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.request import Request
from repro_torch.obs import host
from repro_torch.serving.api import ServeSpec

EXECUTOR_PHASES = {
    "executor.decode": [["prep", "launch", "readback", "pick"]],
    "executor.prefill_chunk": [["prep", "launch"],
                               ["prep", "launch", "readback", "pick"]],
    "executor.extract_kv": [["prep", "launch"]],
    "executor.inject_kv": [["prep", "launch"], ["prep"]],
}


def _service():
    return ServeSpec(arch="llama3-8b", smoke=True, approach="cronus",
                     executor="paged", max_slots=4, block_size=4,
                     max_batched_tokens=16, num_kv_blocks=128
                     ).build(device="cpu")


def _serve(service, tag, n=4, out_len=4):
    rng = np.random.default_rng(len(tag))
    reqs = [Request(f"{tag}{i}", rng.integers(0, 256, 20 + 7 * i)
                    .astype(np.int32), out_len, arrival=service.now)
            for i in range(n)]
    for r in reqs:
        service.submit(r)
    while service.n_active:
        assert service.step()
    return reqs


@pytest.fixture(scope="module")
def profiled():
    """One run served under a CPU profiler session, with its records."""
    service = _service()
    _serve(service, "warm", n=1)              # a span site finds no profiler
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reqs = _serve(service, "p")
    return service, reqs, host.session(), prof


def test_no_profiler_records_nothing():
    service = _service()
    before = host.session()
    n = len(before.spans) if before is not None else 0
    _serve(service, "off", n=2)
    assert host.session() is before
    assert (len(before.spans) if before is not None else 0) == n
    assert not host.span("engine.step") and host.span("x") is host.OFF


def test_spans_nest_as_the_calls_do(profiled):
    _, _, sess, _ = profiled
    spans = sess.spans
    names = {sp.name for sp in spans}
    assert {"runtime.tick", "pair.submit", "engine.step", "executor.decode",
            "executor.prefill_chunk", "executor.extract_kv",
            "executor.inject_kv"} <= names
    for sp in spans:
        assert sp.t1 >= sp.t0 > 0
        parent = spans[sp.parent] if sp.parent >= 0 else None
        if sp.name == "runtime.tick":
            assert parent is None
        elif sp.name in ("engine.step", "pair.submit"):
            assert parent.name == "runtime.tick"
        else:
            assert parent.name == "engine.step"
            assert sp.args["engine"] == parent.args["engine"]
        if parent is not None:
            assert parent.t0 <= sp.t0 <= sp.t1 <= parent.t1
    steps = [sp for sp in spans if sp.name == "engine.step"]
    assert {sp.args["engine"] for sp in steps} == {"ppi", "cpi"}
    for sp in spans:
        if sp.name == "executor.decode":
            assert sp.args["lanes"] == len(sp.args["reqs"]) > 0


def test_phases_are_ordered_and_inside_their_span(profiled):
    _, _, sess, _ = profiled
    for sp in sess.spans:
        if not sp.name.startswith("executor."):
            assert sp.phases == []
            continue
        phases = sp.phases
        assert [p[0] for p in phases] in EXECUTOR_PHASES[sp.name]
        starts = [a for _, a, _ in phases]
        assert starts[0] == sp.t0 and starts == sorted(starts)
        assert phases[-1][2] == sp.t1 >= starts[-1]


def test_a_request_keeps_its_id_from_ppi_to_cpi(profiled):
    _, reqs, sess, _ = profiled

    def ids(name, engine):
        return {sp.args["req"] for sp in sess.spans
                if sp.name == name and sp.args["engine"] == engine}
    split = {r.req_id for r in reqs if 0 < r.partial_len < r.input_len}
    assert split, "no request was split between the two engines"
    for name, engine in (("executor.prefill_chunk", "ppi"),
                         ("executor.extract_kv", "ppi"),
                         ("executor.inject_kv", "cpi"),
                         ("executor.prefill_chunk", "cpi")):
        assert split <= ids(name, engine), (name, engine)
    decoded = set().union(*(sp.args["reqs"] for sp in sess.spans
                            if sp.name == "executor.decode"))
    assert {r.req_id for r in reqs} <= decoded


def test_a_new_session_starts_an_empty_buffer(profiled):
    service, _, first, _ = profiled
    n_first = len(first.spans)
    _serve(service, "between", n=1)       # no profiler: the session ends
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(service, "second", n=1)
    sess = host.session()
    assert sess is not first and len(first.spans) == n_first
    assert sess.spans and sess.perf_ns >= first.spans[-1].t1
    assert all(sp.t0 >= sess.perf_ns for sp in sess.spans)


def test_anchor_lays_spans_on_the_profilers_clock(profiled):
    """Every matrix product the profiler saw was issued inside the launch
    phase of an executor span and ended inside that span, once the span
    is mapped through the anchor."""
    _, _, sess, prof = profiled
    launches = [(sess.to_epoch_ns(a), sess.to_epoch_ns(b),
                 sess.to_epoch_ns(sp.t1))
                for sp in sess.spans for name, a, b in sp.phases
                if name == "launch"]
    mms = [(ev.start_ns(), ev.start_ns() + ev.duration_ns())
           for ev in prof.profiler.kineto_results.events()
           if ev.name() == "aten::mm"]
    assert mms
    for a, b in mms:
        assert any(s <= a < e and b <= end for s, e, end in launches), (a, b)
