"""Greedy-constructive topology search with beam refinement over
``find_capacity`` probes.

The planner answers the operator question HexGen-2 frames as placement
optimization: *given this rack and this workload, what topology should I
serve?* Objective: SLO-sustainable capacity per A100-equivalent
device-second (``CapacityResult.rate / layout_cost_rate``), so a layout
only earns its devices — leaving a weak GPU idle beats attaching it
where it dilutes cost-efficiency.

Search shape (both phases measure, never estimate):

  **Phase A — greedy construction.** Start from the empty layout and
  repeatedly extend each beam layout by one node template the remaining
  inventory can build. Every extension is measured with
  :func:`~repro_torch.workloads.find_capacity` and the ``beam_width`` best
  layouts survive to the next round; construction stops when no
  extension improves on the incumbent best or the endpoint cap is hit.
  Greedy-with-beam covers the layout lattice without the exponential
  sweep of full enumeration, and keeps every measured point as a ranked
  candidate.

  **Phase B — refinement.** The ``refine_top`` best layouts are crossed
  with router choices and ``@policy``/``@cache`` suffix variants
  (:func:`~repro_torch.autotopo.space.suffix_variants`) — the cheap,
  structure-preserving moves — and re-measured.

Every probe goes through :class:`EvalMemo`, keyed on the *canonical* DSL
string + router + workload spec + probe-bracket parameters. The memo
round-trips to JSON, so a re-planned or CI-resumed search re-runs zero
completed probes, and two spellings of one topology never cost two
measurements. Determinism: enumeration order is sorted, ties break on
the canonical string, and probe traces are seeded — same inventory +
workload + seed ⇒ the same ranked plan, bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.autoscale.inventory import DeviceInventory
from repro_torch.autotopo.space import Candidate, WorkloadSpec, \
    layout_cost_rate, node_templates, parse_workload, router_choices, \
    suffix_variants
from repro_torch.cluster.topology import canonical_cluster_spec
from repro_torch.workloads.sweep import CapacityResult, find_capacity


class EvalMemo:
    """Persistent probe cache: (workload, canonical layout, router,
    bracket) -> :class:`CapacityResult`. The bracket parameters are part
    of the key, so a search with different probe settings never reuses a
    stale measurement; JSON round-trip (:meth:`save`/:meth:`load`) lets
    re-planning and CI skip every completed probe."""

    def __init__(self, entries: Optional[Dict[str, Dict]] = None):
        self._entries: Dict[str, Dict] = dict(entries or {})
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(workload: WorkloadSpec, candidate: Candidate,
            bracket: Dict[str, float]) -> str:
        """Memo key of one probe: workload, layout, router and bracket."""
        probe = ",".join(f"{k}={bracket[k]!r}" for k in sorted(bracket))
        return (f"{workload.spec}|{candidate.cluster}"
                f"|{candidate.router}|{probe}")

    def get(self, key: str) -> Optional[CapacityResult]:
        """The stored measurement under ``key``, or None."""
        e = self._entries.get(key)
        if e is None:
            return None
        return CapacityResult(rate=e["rate"], target=e["target"],
                              evaluations=tuple(
                                  (r, g) for r, g in e["evaluations"]))

    def put(self, key: str, result: CapacityResult) -> None:
        """Store one measurement under ``key``."""
        self._entries[key] = {
            "rate": result.rate, "target": result.target,
            "evaluations": [list(e) for e in result.evaluations],
        }

    def __len__(self) -> int:
        return len(self._entries)

    def to_dict(self) -> Dict:
        """The memo as JSON-ready data (the JAX package's format)."""
        return {"entries": self._entries}

    @classmethod
    def from_dict(cls, d: Dict) -> "EvalMemo":
        """A memo from :meth:`to_dict`'s data."""
        return cls(d.get("entries", {}))

    def save(self, path: str) -> None:
        """Write the memo to ``path`` as JSON."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "EvalMemo":
        """Read a memo that :meth:`save` wrote (either package's)."""
        with open(path) as f:
            return cls.from_dict(json.load(f))


@dataclasses.dataclass(frozen=True)
class PlanCandidate:
    """One measured point of the plan: a candidate with its probe
    outcome and cost accounting."""

    cluster: str
    router: str
    capacity_qps: float       # find_capacity's sustained rate (0 = unsustainable)
    cost_rate: float          # A100-equivalents per second (DeviceLedger pricing)
    score: float              # capacity per cost — the ranking objective
    n_probes: int             # open-loop runs this measurement took
    from_memo: bool           # True when the memo supplied it probe-free

    def to_dict(self) -> Dict:
        """The candidate's fields as a dict."""
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PlanResult:
    """Ranked outcome of one planner run. ``ranked[0]`` is the
    recommendation; ``probes`` is the full measurement history in probe
    order (rate/goodput pairs flattened per candidate) for plotting the
    search trajectory."""

    inventory: str                      # the rack searched
    workload: str                       # WorkloadSpec.spec
    ranked: List[PlanCandidate]
    probes: List[Dict]                  # history rows, probe order
    n_evaluations: int                  # capacity measurements run live
    n_memo_hits: int                    # measurements served by the memo
    spec_kw: Dict = dataclasses.field(default_factory=dict)

    @property
    def best(self) -> PlanCandidate:
        """The top-ranked candidate (raises on an empty plan)."""
        if not self.ranked:
            raise ValueError("empty plan: no candidate was measured")
        return self.ranked[0]

    def to_dict(self) -> Dict:
        """The plan as JSON-ready data (``--plan-out``)."""
        return {
            "inventory": self.inventory, "workload": self.workload,
            "ranked": [c.to_dict() for c in self.ranked],
            "probes": self.probes,
            "n_evaluations": self.n_evaluations,
            "n_memo_hits": self.n_memo_hits,
            "spec_kw": dict(self.spec_kw),
        }

    def summary(self, top: int = 5) -> str:
        """Human-readable ranking table for ``serve.py --plan``."""
        lines = [
            f"plan for rack [{self.inventory}] on workload "
            f"[{self.workload}]",
            f"{len(self.ranked)} candidates measured "
            f"({self.n_evaluations} live, {self.n_memo_hits} from memo)",
            f"{'rank':>4}  {'cap qps':>8}  {'cost':>6}  {'score':>7}  "
            f"router / topology",
        ]
        for i, c in enumerate(self.ranked[:top], start=1):
            lines.append(f"{i:>4}  {c.capacity_qps:>8.3f}  "
                         f"{c.cost_rate:>6.2f}  {c.score:>7.3f}  "
                         f"{c.router} / {c.cluster}")
        return "\n".join(lines)


class TopologyPlanner:
    """See the module docstring for the search shape. ``spec_kw`` is
    forwarded into every probe's :class:`~repro_torch.serving.api.ServeSpec`
    (arch/smoke/executor knobs); the plan records it so
    ``ServeSpec.from_plan`` reproduces probe conditions exactly."""

    def __init__(self, inventory: "DeviceInventory | str",
                 workload: "WorkloadSpec | str", *,
                 beam_width: int = 2,
                 refine_top: int = 2,
                 max_endpoints: int = 4,
                 pair_kinds: Sequence[str] = ("cronus",),
                 routers: Sequence[str] = ("round_robin", "least_loaded"),
                 policies: Sequence[str] = ("sarathi",),
                 try_cache: Optional[bool] = None,
                 probe_lo: float = 0.25,
                 probe_hi: Optional[float] = None,
                 rel_tol: float = 0.15,
                 max_iters: int = 6,
                 memo: Optional[EvalMemo] = None,
                 spec_kw: Optional[Dict] = None,
                 make_service: Optional[Callable] = None):
        if isinstance(inventory, str):
            inventory = DeviceInventory.parse(inventory)
        if inventory.total == 0:
            raise ValueError("cannot plan over an empty rack — give a "
                             "non-empty inventory like 'A100:1,A10:2'")
        if beam_width < 1 or refine_top < 0:
            raise ValueError("beam_width must be >= 1 and refine_top >= 0")
        self.inventory = inventory
        self.workload = parse_workload(workload)
        self.beam_width = beam_width
        self.refine_top = refine_top
        self.max_endpoints = max_endpoints
        self.pair_kinds = tuple(pair_kinds)
        self.routers = tuple(routers)
        self.policies = tuple(policies)
        # @cache only pays on shared-prefix workloads; let the workload
        # decide unless the caller forces it
        self.try_cache = (self.workload.trace == "shared_prefix"
                          if try_cache is None else try_cache)
        self.probe_lo = probe_lo
        self.probe_hi = probe_hi
        self.rel_tol = rel_tol
        self.max_iters = max_iters
        self.memo = memo if memo is not None else EvalMemo()
        # non-smoke null-executor probes: the roofline cost model needs the
        # real arch's FLOPs for capacities to mean anything (the smoke
        # config's iteration times are overhead-dominated and never
        # saturate); simulation speed is iteration-count-bound either way
        self.spec_kw = dict(spec_kw or {})
        self._make_service = make_service
        self.probes: List[Dict] = []
        self._measured: Dict[Candidate, PlanCandidate] = {}
        self.n_evaluations = 0

    # ------------------------------------------------------------------
    # one measured point
    # ------------------------------------------------------------------
    def _bracket(self, candidate: Candidate) -> Dict[str, float]:
        hi = self.probe_hi
        if hi is None:
            # FLOPS-prior-derived upper bracket: generous enough that the
            # bisection, not the bracket, finds the edge (a saturated
            # bracket would score every layout identically, because
            # UNIT_COST is itself flops-proportional); deterministic per
            # layout so memo keys are stable
            hi = max(12.0 * candidate.capacity_prior, 2.0 * self.probe_lo)
        return {"lo": self.probe_lo, "hi": hi, "rel_tol": self.rel_tol,
                "max_iters": float(self.max_iters),
                "seed": float(self.workload.seed)}

    def _service_factory(self, candidate: Candidate) -> Callable[[], object]:
        if self._make_service is not None:
            return lambda: self._make_service(candidate)
        from repro_torch.serving.api import ServeSpec
        spec = ServeSpec(cluster=candidate.cluster, router=candidate.router,
                         **self.spec_kw)
        return spec.build

    def evaluate(self, candidate: Candidate) -> PlanCandidate:
        """Measure one candidate (memo first), recording the probe row."""
        if candidate in self._measured:
            return self._measured[candidate]
        bracket = self._bracket(candidate)
        key = EvalMemo.key(self.workload, candidate, bracket)
        result = self.memo.get(key)
        from_memo = result is not None
        if from_memo:
            self.memo.hits += 1
        else:
            self.memo.misses += 1
            self.n_evaluations += 1
            w = self.workload
            result = find_capacity(
                self._service_factory(candidate), w.make_requests,
                bracket["lo"], bracket["hi"], target=w.target,
                ttft_slo=w.ttft_slo, tbt_slo=w.tbt_slo,
                rel_tol=self.rel_tol, max_iters=self.max_iters,
                seed=w.seed)
            self.memo.put(key, result)
        cost = layout_cost_rate(candidate.cluster)
        pc = PlanCandidate(
            cluster=candidate.cluster, router=candidate.router,
            capacity_qps=result.rate, cost_rate=cost,
            score=result.rate / cost, n_probes=len(result.evaluations),
            from_memo=from_memo)
        self._measured[candidate] = pc
        self.probes.append({
            "cluster": candidate.cluster, "router": candidate.router,
            "evaluations": [list(e) for e in result.evaluations],
            "capacity_qps": result.rate, "score": pc.score,
            "from_memo": from_memo,
        })
        return pc

    # ------------------------------------------------------------------
    # the search
    # ------------------------------------------------------------------
    def _default_candidate(self, layout: str) -> Candidate:
        return Candidate(layout, router_choices(layout, self.routers)[0])

    def _extensions(self, layout: Optional[str]) -> List[str]:
        """Layouts reachable from ``layout`` by adding one buildable node
        (canonical, deduped, sorted — the determinism anchor)."""
        remaining = DeviceInventory(dict(self.inventory.counts))
        nodes: List[str] = []
        if layout:
            from repro_torch.cluster.topology import parse_cluster_spec
            spec = parse_cluster_spec(layout)
            if sum(n.count for n in spec.nodes) >= self.max_endpoints:
                return []
            for n in spec.nodes:
                for _ in range(n.count):
                    remaining.take(n.devices)
                    nodes.append(dataclasses.replace(n, count=1).spec)
        out: Dict[str, None] = {}
        for node, devices in node_templates(self.inventory, self.pair_kinds):
            if remaining.can_build(devices):
                out[canonical_cluster_spec(",".join(nodes + [node]))] = None
        return sorted(out)

    def plan(self) -> PlanResult:
        """Run both phases and return the ranked plan."""
        # -- Phase A: greedy construction under a beam ------------------
        beam: List[Tuple[PlanCandidate, str]] = []
        frontier = self._extensions(None)
        best_score = float("-inf")
        while frontier:
            scored = []
            for layout in frontier:
                pc = self.evaluate(self._default_candidate(layout))
                scored.append((pc, layout))
            scored.sort(key=lambda t: (-t[0].score, t[1]))
            improved = scored and scored[0][0].score > best_score
            if improved:
                best_score = scored[0][0].score
            beam = scored[:self.beam_width]
            if not improved:
                break     # adding nodes stopped paying — construction done
            frontier = sorted({ext for _, layout in beam
                               for ext in self._extensions(layout)})
        # -- Phase B: router / suffix refinement of the leaders ---------
        leaders = sorted(self._measured.values(),
                         key=lambda c: (-c.score, c.cluster, c.router))
        for leader in leaders[:self.refine_top]:
            variants = [leader.cluster] + suffix_variants(
                leader.cluster, policies=self.policies,
                cache=self.try_cache)
            for layout in variants:
                for router in router_choices(layout, self.routers):
                    self.evaluate(Candidate(layout, router))
        ranked = sorted(self._measured.values(),
                        key=lambda c: (-c.score, c.cluster, c.router))
        return PlanResult(
            inventory=self.inventory.spec, workload=self.workload.spec,
            ranked=ranked, probes=list(self.probes),
            n_evaluations=self.n_evaluations, n_memo_hits=self.memo.hits,
            spec_kw=dict(self.spec_kw))


def plan_topology(inventory: "DeviceInventory | str",
                  workload: "WorkloadSpec | str", **kw) -> PlanResult:
    """One-call convenience: ``TopologyPlanner(...).plan()``."""
    return TopologyPlanner(inventory, workload, **kw).plan()


def hand_baselines(inventory: "DeviceInventory | str") -> Dict[str, str]:
    """The two layouts an operator writes without a planner, as canonical
    DSL: ``workers`` — every device a standalone worker (the homogeneous
    data-parallel reflex); ``pairs`` — greedily pair the fastest device
    with the slowest available (the all-cronus-pairs reflex), leftovers
    as workers. Both consume the whole rack — that is the point: hand
    layouts spend every device, the planner spends only the ones that
    pay."""
    if isinstance(inventory, str):
        inventory = DeviceInventory.parse(inventory)
    from repro_torch.serving.hardware import DEVICES
    workers = [f"worker:{d}" for d, n in inventory.counts.items()
               for _ in range(n)]
    rack = DeviceInventory(dict(inventory.counts))
    pairs: List[str] = []
    while True:
        types = sorted(rack.counts, key=lambda d: (-DEVICES[d].flops, d))
        hi, lo = (types[0], types[-1]) if types else (None, None)
        if hi is None or hi == lo \
                or DEVICES[hi].flops <= DEVICES[lo].flops:
            break
        rack.take((hi, lo))
        pairs.append(f"cronus:{hi}+{lo}")
    pairs += [f"worker:{d}" for d, n in rack.counts.items()
              for _ in range(n)]
    return {"workers": canonical_cluster_spec(",".join(workers)),
            "pairs": canonical_cluster_spec(",".join(pairs))}
