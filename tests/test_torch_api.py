"""The port's serving surface against the JAX package's: ``ServeSpec``
(JSON, validation, CLI), ``InferenceService`` on the NullExecutor (every
approach, a cluster under each router, open-loop arrivals, autoscaling,
streaming and cancellation), the arrival processes and the capacity
search, the flight recorder, and the ``repro_torch.launch.serve``
launcher.

The control plane is a copy of the JAX package's, so on the same trace
the aggregates are equal key for key (no tolerance: the simulated clocks
are the same float arithmetic).
"""
import argparse
import dataclasses
import importlib
import json
import sys

import numpy as np
import pytest

from repro.serving import trace as jax_trace
from repro.serving.api import ServeSpec as JaxSpec
from repro.workloads import OpenLoopDriver as JaxDriver
from repro.workloads import find_capacity as jax_find_capacity
from repro.workloads import parse_arrival as jax_parse_arrival
from repro_torch.cluster.router import ROUTERS
from repro_torch.configs import ARCH_IDS
from repro_torch.serving import trace
from repro_torch.serving.api import ServeSpec
from repro_torch.serving.simulator import APPROACHES
from repro_torch.workloads import (ARRIVAL_KINDS, OpenLoopDriver,
                                   find_capacity, parse_arrival)

# ---------------------------------------------------------------------------
# ServeSpec: JSON, validation, CLI
# ---------------------------------------------------------------------------

SPECS = {
    "default": {},
    "cluster": dict(cluster="2xcronus:A100+A10,4xworker:A10@sjf",
                    router="prefix_affinity"),
    "real": dict(executor="real", smoke=True, s_kv=256, chunk_pad=16,
                 max_slots=8, block_size=4),
    "paged": dict(executor="paged", approach="dp", num_kv_blocks=64,
                  prefix_cache=True, host_kv_blocks=16),
    "open_loop": dict(arrival="ramp:1:8:120",
                      autoscale="slo:goodput>=0.9:cooldown=5",
                      inventory="A100:1,A10:4"),
}


@pytest.mark.parametrize("kw", SPECS.values(), ids=SPECS.keys())
def test_spec_to_dict_equals_jax(kw):
    spec = ServeSpec(**kw)
    assert spec.to_dict() == JaxSpec(**kw).to_dict()
    assert list(spec.to_dict()) == list(JaxSpec(**kw).to_dict())
    assert ServeSpec.from_dict(json.loads(json.dumps(spec.to_dict()))) \
        == spec


# the cases of tests/test_api.py::test_spec_validation_errors, plus the
# pool, host-tier and autoscale refusals
BAD_SPECS = [
    (dict(arch="gpt5"), "unknown arch"),
    (dict(approach="magic"), "unknown approach"),
    (dict(hi="H100"), "unknown device"),
    (dict(router="hash_ring"), "unknown router"),
    (dict(sched_policy="edf"), "unknown sched policy"),
    (dict(executor="cuda"), "unknown executor"),
    (dict(cluster="9q:A10"), "bad node spec"),
    (dict(executor="real", prefix_cache=True), "executor='paged'"),
    (dict(executor="real", cluster="2xworker:A10@cache"), "executor='paged'"),
    (dict(max_slots=0), "max_slots"),
    (dict(s_kv=0), "s_kv"),
    (dict(approach="dp", max_batched_tokens=64), "fixed per-engine"),
    (dict(approach="pp", max_batched_tokens=64), "fixed per-engine"),
    (dict(arrival="warp:9"), "unknown arrival process"),
    (dict(arrival="poisson:-3"), "rate > 0"),
    (dict(num_kv_blocks=8), "sizes the paged executor"),
    (dict(host_kv_blocks=4), "host-memory tier"),
    (dict(inventory="A10:4"), "inventory without autoscale"),
    (dict(autoscale="slo"), "non-empty device inventory"),
    (dict(autoscale="slo", inventory="A10:1", executor="paged"),
     "simulation-only"),
]


@pytest.mark.parametrize("kw,msg", BAD_SPECS,
                         ids=[m for _, m in BAD_SPECS])
def test_spec_validation_errors_equal_jax(kw, msg):
    with pytest.raises(ValueError, match=msg) as got:
        ServeSpec(**kw)
    with pytest.raises(ValueError, match=msg) as want:
        JaxSpec(**kw)
    assert str(got.value) == str(want.value)


def test_cli_covers_every_spec_field_and_matches_jax():
    ap, jap = argparse.ArgumentParser(), argparse.ArgumentParser()
    ServeSpec.add_cli_args(ap)
    JaxSpec.add_cli_args(jap)
    dests = {a.dest for a in ap._actions}
    for f in dataclasses.fields(ServeSpec):
        cli = {"executor": "real"}.get(f.name, f.name)
        assert cli in dests, f"ServeSpec.{f.name} has no CLI flag"
    assert ServeSpec.from_cli(ap.parse_args([])) == ServeSpec()
    for argv in (["--approach", "dp", "--sched-policy", "sarathi",
                  "--prefix-cache", "--max-slots", "64"],
                 ["--real", "--smoke", "--s-kv", "128"],
                 ["--executor", "paged", "--num-kv-blocks", "32"],
                 ["--cluster", "2xworker:A10", "--router", "kv_aware",
                  "--arrival", "poisson:6"]):
        assert ServeSpec.from_cli(ap.parse_args(argv)).to_dict() == \
            JaxSpec.from_cli(jap.parse_args(argv)).to_dict()


# ---------------------------------------------------------------------------
# InferenceService on the NullExecutor: equal to the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_null_aggregates_equal_jax(arch):
    """Every architecture of the registry is accepted, and on a
    20-request trace its NullExecutor aggregates (the device models'
    clocks read the config's sizes) equal the JAX package's, key for
    key. (On the A100 + A10 pair the three largest models complete 2 of
    the 20 in both packages.)"""
    kw = dict(seed=0, interval=0.1)
    got = ServeSpec(arch=arch).build().run(trace.make_trace(20, **kw))
    want = JaxSpec(arch=arch).build().run(jax_trace.make_trace(20, **kw))
    assert got["completed"] > 0
    assert got == want


@pytest.mark.parametrize("interval", [0.0, 1 / 7.0],
                         ids=["maxtput", "staggered"])
@pytest.mark.parametrize("approach", APPROACHES)
def test_service_run_equals_jax(approach, interval):
    kw = dict(seed=0, interval=interval)
    got = ServeSpec(approach=approach).build().run(trace.make_trace(50, **kw))
    want = JaxSpec(approach=approach).build().run(
        jax_trace.make_trace(50, **kw))
    assert got["completed"] == 50
    assert got == want


@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_cluster_service_equals_jax_under_each_router(router):
    kw = dict(cluster="2xcronus:A100+A10,2xworker:A10@cache",
              router=router)
    tk = dict(seed=2, interval=1 / 12.0, sessions=6)
    got = ServeSpec(**kw).build().run(trace.make_trace(60, **tk))
    want = JaxSpec(**kw).build().run(jax_trace.make_trace(60, **tk))
    assert got["completed"] == 60
    assert got == want


@pytest.mark.parametrize("arrival", ["poisson:6", "burst:6:3:2"])
def test_open_loop_driver_equals_jax(arrival):
    kw = dict(seed=1, arrival=arrival, scale=0.5)
    driver = OpenLoopDriver(ServeSpec(approach="cronus").build())
    driver.run(trace.make_trace(80, **kw))
    jdriver = JaxDriver(JaxSpec(approach="cronus").build())
    jdriver.run(jax_trace.make_trace(80, **kw))
    got, want = driver.metrics(), jdriver.metrics()
    assert got["completed"] == 80 and "queueing_p99" in got
    assert got == want


def test_autoscale_run_equals_jax():
    kw = dict(approach="cronus", arrival="ramp:2:8:60",
              autoscale="slo:goodput>=0.9:cooldown=5",
              inventory="A100:1,A10:4")
    tk = dict(seed=0, arrival=kw["arrival"], scale=0.5)
    out = []
    for spec, mk, drv in ((ServeSpec, trace.make_trace, OpenLoopDriver),
                          (JaxSpec, jax_trace.make_trace, JaxDriver)):
        d = drv(spec(**kw).build())
        d.run(mk(150, **tk))
        m = d.metrics()
        m["autoscale"] = d.service.autoscaler.report(d.service.now)
        out.append(m)
    got, want = out
    assert got["completed"] == 150
    assert got == want


def test_stream_and_cancel_equal_jax():
    """The first request's token stream, then a cancellation mid-decode:
    the same timestamps and the same fleet metrics as the JAX service."""
    out = []
    for spec, mk in ((ServeSpec, trace.make_trace),
                     (JaxSpec, jax_trace.make_trace)):
        service = spec(approach="cronus").build()
        handles = [service.submit(r) for r in mk(6, seed=6, interval=0.25)]
        stream = []
        for n, item in enumerate(handles[0].tokens(), start=1):
            stream.append(item)
            if n == 4:
                break
        assert handles[1].cancel() and handles[1].status == "cancelled"
        m = service.drain()
        assert handles[0].done and handles[0].status == "finished"
        for eng in service.engines:
            eng.allocator.check_invariants()
            assert eng.allocator.num_free == eng.allocator.num_blocks
        out.append((stream, m))
    (stream, got), (jstream, want) = out
    assert stream == jstream and len(stream) == 4
    assert got["cancelled"] == 1 and got["completed"] == 5
    assert got == want


# the flight recorder: a Cronus pair (KV-transfer flows) and a cluster
# with prefix caching (allocator hooks) under prefix affinity
TRACED = {"cronus": dict(approach="cronus"),
          "cluster": dict(cluster="2xcronus:A100+A10,2xworker:A10@cache",
                          router="prefix_affinity")}


@pytest.mark.parametrize("kw", TRACED.values(), ids=TRACED.keys())
def test_flight_recorder_equals_jax(kw):
    """The recorded events, in emission order, equal the JAX tracer's:
    every hook in the runtime, engines, pairs and allocators fires with
    the same arguments at the same simulated times."""
    out = []
    for spec, mk in ((ServeSpec, trace.make_trace),
                     (JaxSpec, jax_trace.make_trace)):
        service = spec(**kw).build()
        tracer = service.start_trace()
        assert service.start_trace() is tracer
        service.run(mk(40, seed=3, interval=1 / 10.0, sessions=4))
        out.append(tracer.to_chrome())
    got, want = out
    assert got == want
    phases = {e["ph"] for e in got}
    assert {"X", "C", "b", "e"} <= phases
    if "approach" in kw:
        assert {"s", "f"} <= phases       # the PPI->CPI handoff flows


# ---------------------------------------------------------------------------
# workloads: the same numpy draws, the same capacity
# ---------------------------------------------------------------------------

ARRIVALS = {"fixed": "fixed:0.25", "poisson": "poisson:4",
            "burst": "burst:4:3:2", "ramp": "ramp:2:8:30"}


@pytest.mark.parametrize("kind", ARRIVAL_KINDS)
def test_arrival_draws_equal_jax(kind):
    proc, jproc = parse_arrival(ARRIVALS[kind]), jax_parse_arrival(
        ARRIVALS[kind])
    assert proc.spec == jproc.spec
    for seed in (0, 7):
        got = proc.times(200, np.random.default_rng(seed))
        want = jproc.times(200, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)


def test_find_capacity_equals_jax():
    out = []
    for spec, mk, fc in ((ServeSpec, trace.make_trace, find_capacity),
                         (JaxSpec, jax_trace.make_trace, jax_find_capacity)):
        res = fc(lambda: spec(approach="pp").build(),
                 lambda rate, seed: mk(20, seed=seed,
                                       arrival=f"poisson:{rate:g}",
                                       scale=0.2),
                 1.0, 16.0, rel_tol=0.1, max_iters=5, seed=3)
        out.append((res.rate, res.evaluations))
    assert out[0] == out[1]
    assert out[0][0] > 0


# ---------------------------------------------------------------------------
# the launcher (in process; tests/test_torch_isolation.py runs it as
# ``python -m repro_torch.launch.serve``)
# ---------------------------------------------------------------------------

def _main(module, argv, monkeypatch, capsys):
    """Run a launcher's ``main`` with ``argv``; returns (exit code or
    message, stdout)."""
    monkeypatch.setattr(sys, "argv", [module, *argv])
    code = 0
    try:
        importlib.import_module(module).main()
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def test_launch_serve_prints_the_jax_metrics(monkeypatch, capsys):
    """``repro_torch.launch.serve`` and ``repro.launch.serve`` print the
    same metrics JSON for the same flags (cluster DSL, least-loaded)."""
    argv = ["--cluster", "2xcronus:A100+A10,2xworker:A10", "--router",
            "least_loaded", "--n-requests", "60", "--interval", "0.1"]
    code, got = _main("repro_torch.launch.serve", argv, monkeypatch, capsys)
    _, want = _main("repro.launch.serve", argv, monkeypatch, capsys)
    assert code == 0
    assert json.loads(got) == json.loads(want)
    assert json.loads(got)["completed"] == 60


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launch_serve_every_arch_prints_the_jax_metrics(arch, monkeypatch,
                                                        capsys):
    """``--arch`` takes every architecture; on the null executor the
    launcher prints the JAX launcher's metrics JSON."""
    argv = ["--arch", arch, "--approach", "cronus", "--n-requests", "5",
            "--interval", "0.1"]
    code, got = _main("repro_torch.launch.serve", argv, monkeypatch, capsys)
    _, want = _main("repro.launch.serve", argv, monkeypatch, capsys)
    assert code == 0
    assert json.loads(got) == json.loads(want)
    assert json.loads(got)["completed"] > 0


def test_launch_serve_flags_and_refusals(tmp_path, monkeypatch, capsys):
    """--help lists the demo flags and --device; a bad spec file and the
    planner's flags exit with a one-line message; --trace-out writes the
    JAX launcher's trace file; --dump-spec writes the JAX package's
    JSON."""
    mod = "repro_torch.launch.serve"
    code, helped = _main(mod, ["--help"], monkeypatch, capsys)
    assert code == 0
    for flag in ("--cluster", "--stream", "--cancel-after", "--spec",
                 "--dump-spec", "--arrival", "--trace-out", "--device"):
        assert flag in helped
    for argv, msg in ((["--spec", str(tmp_path / "none.json")],
                       "bad serving spec"),
                      (["--serve-best"], "need --plan RACK"),
                      (["--workload", "azure:poisson"], "need --plan RACK")):
        code, _ = _main(mod, argv, monkeypatch, capsys)
        assert isinstance(code, str) and msg in code and "\n" not in code
    trace_argv = ["--approach", "cronus", "--n-requests", "20",
                  "--interval", "0.1", "--trace-out"]
    for launcher, name in ((mod, "torch.json"),
                           ("repro.launch.serve", "jax.json")):
        code, _ = _main(launcher, trace_argv + [str(tmp_path / name)],
                        monkeypatch, capsys)
        assert code == 0
    assert json.loads((tmp_path / "torch.json").read_text()) \
        == json.loads((tmp_path / "jax.json").read_text())
    code, dumped = _main(mod, ["--sched-policy", "sarathi", "--dump-spec",
                               "-"], monkeypatch, capsys)
    assert code == 0
    assert json.loads(dumped) == JaxSpec(sched_policy="sarathi").to_dict()
