"""The port's auto-topology planner against the JAX package's.

The planner is pure Python over the copied control plane and probes
candidates on simulated clocks (NullExecutor), so on the same rack and
workload both packages measure the same capacities and rank the same
plan: ``to_dict()`` is compared with ``==``, no tolerance. Probes use the
JAX tests' cheap ``QUICK`` workload with ``max_endpoints=2``.
"""
import importlib
import json
import sys

import pytest

from repro.autoscale import DeviceInventory as JaxInventory
from repro.autotopo import EvalMemo as JaxMemo
from repro.autotopo import TopologyPlanner as JaxPlanner
from repro.autotopo import WorkloadSpec as JaxWorkload
from repro.autotopo import enumerate_layouts as jax_enumerate_layouts
from repro.autotopo import hand_baselines as jax_hand_baselines
from repro.autotopo import parse_workload as jax_parse_workload
from repro.autotopo import plan_topology as jax_plan_topology
from repro.serving.api import ServeSpec as JaxSpec
from repro_torch.autoscale import DeviceInventory
from repro_torch.autotopo import (EvalMemo, TopologyPlanner, WorkloadSpec,
                                  enumerate_layouts, hand_baselines,
                                  parse_workload, plan_topology)
from repro_torch.serving.api import ServeSpec

QUICK = dict(n_requests=12, scale=0.05, target=0.8)
RACK = "A100:1,A10:1"


@pytest.fixture(scope="module")
def plans():
    """One plan of each package on RACK x QUICK (beam 2, 2 endpoints)."""
    return (plan_topology(RACK, WorkloadSpec(**QUICK), max_endpoints=2),
            jax_plan_topology(RACK, JaxWorkload(**QUICK), max_endpoints=2))


def test_plan_equals_jax(plans):
    got, want = plans
    assert got.ranked and got.n_evaluations > 0
    assert got.to_dict() == want.to_dict()
    assert got.summary(5) == want.summary(5)


@pytest.mark.parametrize("rack,beam", [("A100:1,A10:2", 1),
                                       ("A10:2", 2)])
def test_plan_equals_jax_other_racks(rack, beam):
    got = plan_topology(rack, WorkloadSpec(**QUICK), beam_width=beam,
                        max_endpoints=2)
    want = jax_plan_topology(rack, JaxWorkload(**QUICK), beam_width=beam,
                             max_endpoints=2)
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("rack", [RACK, "A100:1,A10:2", "A10:3"])
def test_search_space_equals_jax(rack):
    """The layouts enumerated from a rack and the hand baselines."""
    assert enumerate_layouts(DeviceInventory.parse(rack),
                             max_endpoints=2) == \
        jax_enumerate_layouts(JaxInventory.parse(rack), max_endpoints=2)
    assert hand_baselines(rack) == jax_hand_baselines(rack)


@pytest.mark.parametrize("saver", ["torch", "jax"])
def test_memo_loads_across_packages(plans, saver, tmp_path):
    """A memo saved by one package loads in the other, and the resumed
    plan re-probes nothing and ranks what the fresh plan ranked."""
    got, _ = plans
    path = str(tmp_path / "memo.json")
    if saver == "torch":
        memo = EvalMemo()
        plan_topology(RACK, WorkloadSpec(**QUICK), max_endpoints=2,
                      memo=memo)
        memo.save(path)
        resumed = jax_plan_topology(RACK, JaxWorkload(**QUICK),
                                    max_endpoints=2,
                                    memo=JaxMemo.load(path))
    else:
        memo = JaxMemo()
        jax_plan_topology(RACK, JaxWorkload(**QUICK), max_endpoints=2,
                          memo=memo)
        memo.save(path)
        resumed = plan_topology(RACK, WorkloadSpec(**QUICK),
                                max_endpoints=2, memo=EvalMemo.load(path))
    assert resumed.n_evaluations == 0
    assert resumed.n_memo_hits == got.n_evaluations
    assert [(c.cluster, c.router, c.capacity_qps) for c in resumed.ranked] \
        == [(c.cluster, c.router, c.capacity_qps) for c in got.ranked]
    assert json.load(open(path)) == memo.to_dict()


def test_from_plan_equals_jax(plans):
    """From the plan object and from its JSON, with an override, a rate
    and a second rank; a rank out of range refuses as JAX refuses."""
    got, want = plans
    as_json = json.loads(json.dumps(got.to_dict()))
    for kw in ({}, {"router": "least_loaded"}, {"rate": 3.5},
               {"rank": 1}):
        spec = ServeSpec.from_plan(got, **kw)
        assert spec.to_dict() == JaxSpec.from_plan(want, **kw).to_dict()
        assert ServeSpec.from_plan(as_json, **kw) == spec
    assert ServeSpec.from_plan(got).cluster == got.best.cluster
    assert ServeSpec.from_plan(got).build().endpoints
    for bad in ({"rank": 99}, {"rank": -1}):
        with pytest.raises(ValueError) as e:
            ServeSpec.from_plan(got, **bad)
        with pytest.raises(ValueError) as je:
            JaxSpec.from_plan(want, **bad)
        assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="empty plan"):
        ServeSpec.from_plan({"ranked": []})


BAD_PLANNERS = [
    (("", QUICK), {}),
    (("A10:0", QUICK), {}),
    (("A10:x", QUICK), {}),
    ((RACK, QUICK), {"beam_width": 0}),
    ((RACK, QUICK), {"refine_top": -1}),
    ((RACK, "azure:quantum"), {}),
]


@pytest.mark.parametrize("args,kw", BAD_PLANNERS,
                         ids=["empty", "zero", "count", "beam", "refine",
                              "workload"])
def test_planner_refusals_equal_jax(args, kw):
    rack, work = args
    with pytest.raises(ValueError) as e:
        TopologyPlanner(rack, WorkloadSpec(**work)
                        if isinstance(work, dict) else work, **kw)
    with pytest.raises(ValueError) as je:
        JaxPlanner(rack, JaxWorkload(**work)
                   if isinstance(work, dict) else work, **kw)
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("spec", ["", "azure", "klingon:poisson",
                                  "azure:quantum", "azure:poisson:bogus=1",
                                  "azure:poisson:n=abc", "azure:poisson:n=0"])
def test_workload_refusals_equal_jax(spec):
    with pytest.raises(ValueError) as e:
        parse_workload(spec)
    with pytest.raises(ValueError) as je:
        jax_parse_workload(spec)
    assert str(e.value) == str(je.value)


def _main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [module, *argv])
    code = 0
    try:
        importlib.import_module(module).main()
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def test_launch_plan_serve_best_prints_the_jax_output(monkeypatch, capsys,
                                                      tmp_path):
    """``--plan ... --serve-best`` prints the JAX launcher's ranked plan,
    serving line and metrics; ``--plan-out`` and ``--plan-memo`` write the
    JAX launcher's files."""
    argv = ["--plan", RACK, "--workload",
            "azure:poisson:n=20:ttft=2.0:tbt=0.1", "--serve-best",
            "--plan-max-endpoints", "2"]
    outs = {}
    for mod, tag in (("repro_torch.launch.serve", "torch"),
                     ("repro.launch.serve", "jax")):
        code, outs[tag] = _main(
            mod, argv + ["--plan-out", str(tmp_path / f"{tag}.json"),
                         "--plan-memo", str(tmp_path / f"{tag}-memo.json")],
            monkeypatch, capsys)
        assert code == 0
    assert "# serving " in outs["torch"]
    assert outs["torch"] == outs["jax"]
    for name in ("{}.json", "{}-memo.json"):
        assert json.loads((tmp_path / name.format("torch")).read_text()) \
            == json.loads((tmp_path / name.format("jax")).read_text())
    metrics = json.loads(outs["torch"][outs["torch"].index("\n{") + 1:])
    assert metrics["completed"] == 20
