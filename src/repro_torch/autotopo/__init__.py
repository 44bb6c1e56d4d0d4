"""Auto-topology planner: search the heterogeneous placement space.

Given a spare rack (:class:`~repro_torch.autoscale.inventory.DeviceInventory`)
and a workload (:class:`~repro_torch.autotopo.space.WorkloadSpec`), find the
topology — endpoint grouping, device assignment, router and per-node
``@policy``/``@cache`` suffixes — that maximises SLO-sustainable
capacity per A100-equivalent device-cost, using
:func:`~repro_torch.workloads.find_capacity` as the black-box evaluator. See
:mod:`repro_torch.autotopo.space` for the candidate space and pruning rules,
:mod:`repro_torch.autotopo.planner` for the search and the evaluation memo.
"""
from repro_torch.autotopo.planner import (EvalMemo, PlanCandidate, PlanResult,
                                    TopologyPlanner, hand_baselines,
                                    plan_topology)
from repro_torch.autotopo.space import (ARRIVAL_KINDS, PAIR_KINDS, TRACE_KINDS,
                                  Candidate, WorkloadSpec,
                                  enumerate_layouts, layout_cost_rate,
                                  layout_devices, node_templates,
                                  parse_workload, router_choices,
                                  suffix_variants)

__all__ = [
    "ARRIVAL_KINDS", "PAIR_KINDS", "TRACE_KINDS",
    "Candidate", "WorkloadSpec", "enumerate_layouts", "layout_cost_rate",
    "layout_devices", "node_templates", "parse_workload", "router_choices",
    "suffix_variants",
    "EvalMemo", "PlanCandidate", "PlanResult", "TopologyPlanner",
    "hand_baselines", "plan_topology",
]
