"""Candidate space for the auto-topology planner.

Three pieces turn a :class:`~repro_torch.autoscale.inventory.DeviceInventory`
into a searchable, finite topology space:

  * :class:`WorkloadSpec` — the workload the planner optimises *for*
    (trace family, arrival process, SLOs, goodput target), with a
    round-trippable spec string (``"azure:poisson:n=80:scale=0.05"``)
    that doubles as the evaluation-memo key prefix;
  * :func:`enumerate_layouts` — every endpoint multiset buildable from
    the inventory, as *canonical* topology-DSL strings, pruned by the
    paper's structure (pairs only pair a faster device's decode engine
    with a strictly slower prefill device — the PPI/CPI asymmetry of
    §3 — and fan-out is capped) and deduped so isomorphic layouts are
    enumerated once;
  * :class:`Candidate` — one (layout, router) point of the space, priced
    in A100-equivalent device-seconds through the same
    :class:`~repro_torch.autoscale.inventory.DeviceLedger` the autoscaler
    benchmarks settle cost with.

Pruning rules (why the space stays small):
  * **pair asymmetry** — ``cronus``/``disagg`` nodes are only generated
    as ``KIND:FAST+SLOW`` with ``flops(FAST) > flops(SLOW)``; a
    homogeneous or inverted pair is never a Cronus win (the PPI exists
    to offload prefill *from* the stronger decode device).
  * **fan-out cap** — layouts stop at ``max_endpoints`` routable nodes;
    beyond the cap, additional endpoints only dilute the router's
    choices at quick-rig scales.
  * **canonical dedupe** — every layout is rendered through
    :func:`~repro_torch.cluster.topology.canonical_cluster_spec`, so
    ``"worker:A10,cronus:A100+A10"`` and ``"cronus:A100+A10,worker:A10"``
    cost one evaluation, not two.
  * **idle devices allowed** — a layout need not consume the rack; the
    objective is capacity *per device-cost*, and the strongest move is
    often leaving weak devices idle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.autoscale.inventory import DeviceInventory, DeviceLedger, \
    heuristic_capacity_qps
from repro_torch.cluster.router import ROUTERS
from repro_torch.cluster.topology import canonical_cluster_spec, parse_cluster_spec
from repro_torch.scheduling import SCHEDULERS
from repro_torch.serving.hardware import DEVICES
from repro_torch.serving.trace import Trace, make_shared_prefix_trace, make_trace
from repro_torch.workloads.sweep import DEFAULT_TBT_SLO, DEFAULT_TTFT_SLO

TRACE_KINDS = ("azure", "shared_prefix")
ARRIVAL_KINDS = ("poisson", "burst", "fixed")

# pair kinds the enumerator may generate (all obey the fast+slow rule)
PAIR_KINDS = ("cronus", "disagg_lh", "disagg_hl")


# ---------------------------------------------------------------------------
# the workload half of the planning problem
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """What the planner optimises for: a trace family driven by an
    arrival process against SLO targets. The ``rate`` axis is left free —
    ``find_capacity`` owns it — so one ``WorkloadSpec`` describes the
    whole load curve, and :meth:`make_requests` materialises the probe
    trace at any rate, deterministically per ``seed``."""

    trace: str = "azure"          # trace family (TRACE_KINDS)
    arrival: str = "poisson"      # arrival process family (ARRIVAL_KINDS)
    n_requests: int = 100         # requests per capacity probe
    seed: int = 0                 # probe-trace seed (determinism anchor)
    scale: float = 1.0            # length scale (shrink for CPU-rig runs)
    ttft_slo: float = DEFAULT_TTFT_SLO
    tbt_slo: float = DEFAULT_TBT_SLO
    target: float = 0.9           # goodput the capacity search must hold

    def __post_init__(self):
        if self.trace not in TRACE_KINDS:
            raise ValueError(f"unknown trace kind {self.trace!r}; "
                             f"choose from {TRACE_KINDS}")
        if self.arrival not in ARRIVAL_KINDS:
            raise ValueError(f"unknown arrival kind {self.arrival!r}; "
                             f"choose from {ARRIVAL_KINDS}")
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")
        if not 0 < self.scale <= 1.0:
            raise ValueError(f"scale must be in (0, 1], got {self.scale}")
        if not 0.0 < self.target <= 1.0:
            raise ValueError(f"target must be in (0, 1], got {self.target}")

    # -- spec-string round-trip (the AutoscalePolicy idiom) --------------
    @property
    def spec(self) -> str:
        """Compact string; ``parse_workload(w.spec) == w``. Only
        non-default fields are emitted, so the default workload is just
        ``"azure:poisson"``."""
        default = WorkloadSpec()
        parts = [self.trace, self.arrival]
        for key, field in _WORKLOAD_KEYS.items():
            if getattr(self, field) != getattr(default, field):
                parts.append(f"{key}={getattr(self, field)!r}")
        return ":".join(parts)

    def arrival_spec(self, rate: float) -> str:
        """The :mod:`repro_torch.workloads.arrivals` spec at offered ``rate``."""
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        if self.arrival == "poisson":
            return f"poisson:{rate!r}"
        if self.arrival == "burst":
            return f"burst:{rate!r}"
        return f"fixed:{1.0 / rate!r}"

    def make_requests(self, rate: float,
                      seed: Optional[int] = None) -> Trace:
        """The probe trace at offered ``rate`` — the two-arg factory
        :func:`repro_torch.workloads.find_capacity` calls when given a seed.
        Same (rate, seed) ⇒ byte-identical trace in any process."""
        seed = self.seed if seed is None else seed
        kw = dict(seed=seed, arrival=self.arrival_spec(rate),
                  scale=self.scale)
        if self.trace == "shared_prefix":
            return make_shared_prefix_trace(self.n_requests, **kw)
        return make_trace(self.n_requests, **kw)


# spec-string key -> WorkloadSpec field (trace/arrival are positional)
_WORKLOAD_KEYS = {
    "n": "n_requests",
    "seed": "seed",
    "scale": "scale",
    "ttft": "ttft_slo",
    "tbt": "tbt_slo",
    "target": "target",
}


def parse_workload(spec: "str | WorkloadSpec") -> WorkloadSpec:
    """Inverse of :attr:`WorkloadSpec.spec`, with one-line refusals that
    name the offending part."""
    if isinstance(spec, WorkloadSpec):
        return spec
    parts = [p for p in spec.split(":") if p]
    if len(parts) < 2:
        raise ValueError(f"bad workload spec {spec!r}: expected "
                         "TRACE:ARRIVAL[:key=value...], e.g. "
                         "'azure:poisson:n=80:scale=0.05'")
    kw: Dict = {"trace": parts[0], "arrival": parts[1]}
    fields = {f.name: f.type for f in dataclasses.fields(WorkloadSpec)}
    for part in parts[2:]:
        key, sep, val = part.partition("=")
        if not sep or key not in _WORKLOAD_KEYS:
            raise ValueError(f"bad workload option {part!r} in {spec!r}; "
                             f"known keys: {sorted(_WORKLOAD_KEYS)}")
        field = _WORKLOAD_KEYS[key]
        caster = int if fields[field] == "int" else float
        try:
            kw[field] = caster(val)
        except ValueError:
            raise ValueError(f"bad workload value {part!r} in {spec!r}: "
                             f"expected {caster.__name__}") from None
    return WorkloadSpec(**kw)


# ---------------------------------------------------------------------------
# the topology half: layouts and candidates
# ---------------------------------------------------------------------------

def layout_devices(layout: str) -> Tuple[str, ...]:
    """Every device instance a layout occupies (with multiplicity)."""
    spec = parse_cluster_spec(layout)
    return tuple(d for node in spec.nodes
                 for _ in range(node.count) for d in node.devices)


def layout_cost_rate(layout: str) -> float:
    """A100-equivalent device-seconds one second of this layout costs —
    priced through :class:`DeviceLedger`, the same meter the autoscale
    benchmarks settle with, so planner scores and fleet benchmarks share
    one cost axis."""
    ledger = DeviceLedger()
    ledger.open("layout", layout_devices(layout), 0.0)
    return ledger.device_cost(1.0)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search space: a canonical layout behind one
    router. Hashable, so beams and memo keys use it directly."""

    cluster: str                 # canonical topology-DSL string
    router: str = "least_loaded"

    def __post_init__(self):
        object.__setattr__(self, "cluster",
                           canonical_cluster_spec(self.cluster))
        if self.router not in ROUTERS:
            raise ValueError(f"unknown router {self.router!r}; "
                             f"choose from {sorted(ROUTERS)}")

    @property
    def devices(self) -> Tuple[str, ...]:
        """Device names the layout occupies, one per device."""
        return layout_devices(self.cluster)

    @property
    def cost_rate(self) -> float:
        """The layout's device cost per second (A100-equivalents)."""
        return layout_cost_rate(self.cluster)

    @property
    def n_endpoints(self) -> int:
        """Endpoints (pairs and workers) the layout serves with."""
        return sum(n.count for n in parse_cluster_spec(self.cluster).nodes)

    @property
    def capacity_prior(self) -> float:
        """FLOPS-proportional capacity guess (probe-ordering heuristic)."""
        return heuristic_capacity_qps(self.devices)


def node_templates(inventory: DeviceInventory,
                   pair_kinds: Sequence[str] = ("cronus",),
                   ) -> List[Tuple[str, Tuple[str, ...]]]:
    """The single-endpoint building blocks an inventory supports, as
    ``(node_dsl, devices)`` sorted fastest-first: one standalone worker
    per device type, plus each requested pair kind over every strictly
    flops-asymmetric (fast, slow) type pair — the PPI/CPI pruning rule."""
    for kind in pair_kinds:
        if kind not in PAIR_KINDS:
            raise ValueError(f"unknown pair kind {kind!r}; "
                             f"choose from {PAIR_KINDS}")
    types = sorted(inventory.counts, key=lambda d: (-DEVICES[d].flops, d))
    out: List[Tuple[str, Tuple[str, ...]]] = []
    for t in types:
        out.append((f"worker:{t}", (t,)))
    for i, hi in enumerate(types):
        for lo in types[i + 1:]:
            if DEVICES[hi].flops <= DEVICES[lo].flops:
                continue      # equal-flops types: no asymmetry to exploit
            for kind in pair_kinds:
                out.append((f"{kind}:{hi}+{lo}", (hi, lo)))
    return out


def enumerate_layouts(inventory: DeviceInventory, *,
                      max_endpoints: int = 4,
                      pair_kinds: Sequence[str] = ("cronus",),
                      require_full_rack: bool = False) -> List[str]:
    """Every layout buildable from ``inventory`` with at most
    ``max_endpoints`` endpoints, as sorted canonical DSL strings.

    The recursion walks templates in a fixed order and only ever *adds*
    instances of the current-or-later template, so each multiset is
    generated once; canonicalisation then collapses whatever symmetry
    remains. ``require_full_rack=True`` keeps only layouts that consume
    the whole inventory (the hand-baseline shape); the default allows
    idle devices because the objective is capacity per device-cost."""
    if max_endpoints < 1:
        raise ValueError("max_endpoints must be >= 1")
    templates = node_templates(inventory, pair_kinds)
    seen: Dict[str, None] = {}

    def rec(idx: int, remaining: DeviceInventory, nodes: List[str]):
        if nodes:
            if not require_full_rack or remaining.total == 0:
                seen[canonical_cluster_spec(",".join(nodes))] = None
        if len(nodes) >= max_endpoints:
            return
        for j in range(idx, len(templates)):
            node, devices = templates[j]
            if not remaining.can_build(devices):
                continue
            remaining.take(devices)
            nodes.append(node)
            rec(j, remaining, nodes)
            nodes.pop()
            remaining.put(devices)

    rec(0, DeviceInventory(dict(inventory.counts)), [])
    return sorted(seen)


def router_choices(layout: str,
                   routers: Sequence[str] = ("round_robin", "least_loaded"),
                   ) -> Tuple[str, ...]:
    """Routers worth probing for a layout. A single-endpoint layout has
    nothing to route — ``round_robin`` only; affinity routers
    (``prefix_affinity``/``kv_aware``/``session``) are withheld unless
    some node actually caches (``@cache``), since without KV reuse they
    degenerate to round-robin at extra probe cost."""
    for r in routers:
        if r not in ROUTERS:
            raise ValueError(f"unknown router {r!r}; "
                             f"choose from {sorted(ROUTERS)}")
    spec = parse_cluster_spec(layout)
    if sum(n.count for n in spec.nodes) == 1:
        return ("round_robin",)
    affinity = {"prefix_affinity", "kv_aware", "session"}
    cached = any(n.options.get("prefix_cache") for n in spec.nodes)
    kept = tuple(r for r in routers if cached or r not in affinity)
    return kept or ("least_loaded",)


def suffix_variants(layout: str, *,
                    policies: Sequence[str] = ("sarathi",),
                    cache: bool = False) -> List[str]:
    """Refinement moves on one layout: the layout with a uniform
    ``@policy`` suffix per requested policy, and (``cache=True``) each of
    those plus ``@cache`` on every node. Canonical, deduped, and never
    including the unmodified layout itself."""
    for p in policies:
        if p not in SCHEDULERS:
            raise ValueError(f"unknown sched policy {p!r}; "
                             f"choose from {sorted(SCHEDULERS)}")
    spec = parse_cluster_spec(layout)
    variants: Dict[str, None] = {}

    def emit(policy: Optional[str], cached: bool):
        nodes = []
        for n in spec.nodes:
            opts = dict(n.options)
            if policy is not None:
                opts["sched_policy"] = policy
            if cached:
                opts["prefix_cache"] = True
            nodes.append(dataclasses.replace(n, options=opts))
        text = ",".join(n.spec for n in nodes)
        variants[canonical_cluster_spec(text)] = None

    for policy in policies:
        emit(policy, False)
    if cache:
        emit(None, True)
        for policy in policies:
            emit(policy, True)
    base = canonical_cluster_spec(layout)
    return sorted(v for v in variants if v != base)
