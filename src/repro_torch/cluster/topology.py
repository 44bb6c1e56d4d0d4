"""Declarative cluster topology: compose N heterogeneous devices into any
mix of Cronus pairs, standalone workers, disaggregated pools and pipeline
stages, fronted by one router.

A spec is a list of :class:`NodeSpec` (or the compact string DSL):

    "2xcronus:A100+A10,4xworker:A10"
        -> two Cronus PPI(A10)+CPI(A100) pairs and four standalone A10
           chunked-prefill workers behind one router.

    "cronus:A100+A10@sarathi,2xworker:A10@sjf"
        -> per-endpoint scheduling policies: the ``@policy`` suffix picks
           the iteration-level batch-composition policy for that node's
           engines (see ``repro_torch.scheduling.SCHEDULERS``; default fcfs).

    "2xworker:A10@sarathi@cache"
        -> ``@cache`` turns on shared-prefix KV reuse for that node's
           engines (``EngineConfig.prefix_cache``); combine with
           ``router="prefix_affinity"`` so requests chase their prefix.

    "4xworker:A10@cache@host"
        -> ``@host`` adds a host-memory cache tier behind each engine's
           GPU pool (``EngineConfig.host_kv_blocks``): refcount-0 prefix
           blocks demote to host DRAM instead of being dropped and
           promote back on a hit, PCIe cost charged. Requires caching
           (``@cache`` or the cluster-wide ``prefix_cache``); sized
           4x the GPU pool unless ``host_kv_blocks`` is given globally.

Node kinds:
  * ``cronus:HI+LO``    — Balancer-split pair, prefill on LO, decode on HI
  * ``disagg_lh:HI+LO`` — full prefill on LO, decode-only HI
  * ``disagg_hl:HI+LO`` — full prefill on HI, decode-only LO
  * ``worker:DEV``      — standalone chunked-prefill+decode instance
                          (alias: ``dp``)
  * ``pp:HI+LO``        — two-stage pipeline fused into one engine

``build_cluster`` turns a spec into a :class:`ClusterSystem` whose
``run(requests)`` replays a trace through the shared event loop. A
single-``cronus`` spec builds exactly the engines ``build_cronus`` builds,
so a 1-pair cluster reproduces ``CronusSystem`` results to the bit.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.cluster.router import Router, make_router
from repro_torch.cluster.runtime import ClusterRuntime, Endpoint, WorkerEndpoint
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.scheduling import SCHEDULERS
from repro_torch.serving.hardware import DEVICES, DeviceModel

PAIR_KINDS = ("cronus", "disagg_lh", "disagg_hl")
NODE_KINDS = PAIR_KINDS + ("worker", "pp")

_NODE_RE = re.compile(
    r"^(?:(\d+)x)?([a-z_]+):([A-Za-z0-9+]+)((?:@[a-z_]+)*)$")


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One parsed ``[count x]kind:devices[@options]`` node of a cluster
    spec."""

    kind: str                       # one of NODE_KINDS
    devices: Tuple[str, ...]        # ("A100", "A10") for pairs, ("A10",) ...
    count: int = 1
    options: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        kind = "worker" if self.kind == "dp" else self.kind
        object.__setattr__(self, "kind", kind)
        if kind not in NODE_KINDS:
            raise ValueError(f"unknown node kind {self.kind!r}")
        if self.count < 1:
            raise ValueError(f"node count must be >= 1, got {self.count}")
        want = 1 if kind == "worker" else 2
        if len(self.devices) != want:
            raise ValueError(f"{kind} takes {want} device(s), "
                             f"got {self.devices}")
        for d in self.devices:
            if d not in DEVICES:
                raise ValueError(f"unknown device {d!r}; "
                                 f"choose from {sorted(DEVICES)}")
        policy = self.options.get("sched_policy")
        if policy is not None and policy not in SCHEDULERS:
            raise ValueError(f"unknown sched policy {policy!r}; "
                             f"choose from {sorted(SCHEDULERS)}")

    @property
    def suffixes(self) -> str:
        """The node's ``@`` option suffixes in canonical order (policy,
        then ``cache``, then ``host``)."""
        parts = []
        if "sched_policy" in self.options:
            parts.append(self.options["sched_policy"])
        if self.options.get("prefix_cache"):
            parts.append("cache")
        if self.options.get("host_tier"):
            parts.append("host")
        return "".join(f"@{p}" for p in parts)

    @property
    def spec(self) -> str:
        """This node as a canonical DSL segment
        (``[Nx]kind:dev[+dev][@suffixes]``); ``parse_cluster_spec`` on it
        reproduces the node."""
        count = f"{self.count}x" if self.count > 1 else ""
        return f"{count}{self.kind}:{'+'.join(self.devices)}{self.suffixes}"


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A parsed cluster DSL string: node list + router choice."""

    nodes: Tuple[NodeSpec, ...]
    router: str = "least_loaded"

    @property
    def n_engines(self) -> int:
        """Engines the spec materialises (pairs count 2, pp fuses to 1)."""
        per = {"worker": 1, "pp": 1}
        return sum(per.get(n.kind, 2) * n.count for n in self.nodes)

    @property
    def spec(self) -> str:
        """The node list back as a DSL string (node order preserved)."""
        return ",".join(n.spec for n in self.nodes)


def parse_cluster_spec(text: str, router: str = "least_loaded") -> ClusterSpec:
    """Parse the compact DSL, e.g.
    ``"2xcronus:A100+A10,4xworker:A10@sarathi@cache"``. ``@`` suffixes
    stack: a scheduling-policy name picks the node's batch-composition
    policy, the literal ``cache`` enables shared-prefix KV reuse and
    ``host`` puts a host-memory cache tier behind the GPU pool.

    Every parse error is a one-line ``ValueError`` naming the offending
    segment and its character position in ``text``, so a typo deep in a
    long spec is found without bisecting the string by hand."""
    nodes = []
    offset = 0
    for i, raw in enumerate(text.split(","), start=1):
        part = raw.strip()
        pos = offset + (len(raw) - len(raw.lstrip()))
        offset += len(raw) + 1          # +1 for the consumed comma
        if not part:
            continue
        where = f"segment {i} at char {pos} ({part!r})"
        m = _NODE_RE.match(part)
        if m is None:
            raise ValueError(f"bad node spec in {where}: expected "
                             "[<count>x]<kind>:<dev>[+<dev>][@<policy>]"
                             "[@cache][@host]")
        count, kind, devs, suffixes = m.groups()
        options: Dict = {}
        for suffix in filter(None, (suffixes or "").split("@")):
            if suffix == "cache":
                options["prefix_cache"] = True
            elif suffix == "host":
                options["host_tier"] = True
            elif suffix in SCHEDULERS:
                options["sched_policy"] = suffix
            else:
                raise ValueError(
                    f"bad node spec in {where}: unknown suffix @{suffix} — "
                    f"expected 'cache', 'host' or a policy from "
                    f"{sorted(SCHEDULERS)}")
        try:
            nodes.append(NodeSpec(kind=kind, devices=tuple(devs.split("+")),
                                  count=int(count or 1), options=options))
        except ValueError as e:
            raise ValueError(f"bad node spec in {where}: {e}") from None
    if not nodes:
        raise ValueError(f"empty cluster spec {text!r}")
    return ClusterSpec(nodes=tuple(nodes), router=router)


def canonical_cluster_spec(spec: Union["ClusterSpec", str]) -> str:
    """One canonical DSL string per *isomorphic* topology.

    Two specs that materialise the same endpoint multiset — regardless of
    node order, count grouping (``"worker:A10,worker:A10"`` vs
    ``"2xworker:A10"``) or suffix spelling order (``@cache@sarathi`` vs
    ``@sarathi@cache``) — canonicalise to the same string: nodes are
    expanded, grouped by (kind, devices, options) and re-emitted sorted.
    The auto-topology planner keys its search-space dedupe and its
    evaluation memo on this string, so a layout is never measured twice
    under different spellings. Only DSL-expressible options participate
    (programmatic ``NodeSpec.options`` keys like ``queue_cap`` are not
    spellable and raise on round-trip)."""
    if isinstance(spec, str):
        spec = parse_cluster_spec(spec)
    groups: Dict[Tuple, int] = {}
    for node in spec.nodes:
        key = (node.kind, node.devices,
               tuple(sorted(node.options.items())))
        groups[key] = groups.get(key, 0) + node.count
    merged = [NodeSpec(kind=k, devices=d, count=n, options=dict(o))
              for (k, d, o), n in groups.items()]
    merged.sort(key=lambda x: (x.kind, x.devices, x.suffixes))
    text = ",".join(n.spec for n in merged)
    reparsed = parse_cluster_spec(text)
    if {(n.kind, n.devices, tuple(sorted(n.options.items()))): n.count
            for n in reparsed.nodes} != groups:
        raise ValueError(f"cluster spec does not round-trip through the "
                         f"DSL (programmatic node options?): {text!r}")
    return text


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClusterSystem:
    """A built cluster: endpoints + router, run through the shared loop."""
    endpoints: List[Endpoint]
    router: Router

    @property
    def engines(self) -> List[Engine]:
        """Every engine across every endpoint."""
        return [e for ep in self.endpoints for e in ep.engines]

    def finished(self):
        """Completed requests across the whole cluster."""
        return [r for ep in self.endpoints for r in ep.finished()]

    def run(self, requests, max_steps: int = 10_000_000):
        """Replay a trace through a fresh runtime; aggregate metrics."""
        return ClusterRuntime(self.endpoints, self.router).run(
            requests, max_steps)

    def service(self):
        """This cluster as an online :class:`repro_torch.serving.api.
        InferenceService` (submit/stream/cancel). Lazy import: the api
        module sits above the cluster layer."""
        from repro_torch.serving.api import InferenceService
        return InferenceService(self.endpoints, self.router, system=self)


def _null_factory(role: str):
    from repro_torch.core.executor import NullExecutor
    return NullExecutor()


def build_cluster(cfg, spec: Union[ClusterSpec, str], *,
                  router: Optional[Union[str, Router]] = None,
                  executor_factory: Optional[Callable] = None,
                  max_slots: int = 256, block_size: int = 16,
                  max_batched_tokens: int = 512,
                  worker_queue_cap: Optional[int] = 4,
                  sched_policy: str = "fcfs",
                  prefix_cache: bool = False,
                  num_kv_blocks: Optional[int] = None,
                  host_kv_blocks: int = 0,
                  executor: str = "null") -> ClusterSystem:
    """Materialise a :class:`ClusterSpec` into engines + endpoints.

    ``executor_factory(role)`` is called with ``"ppi"``/``"cpi"`` for pair
    engines and ``"worker"``/``"pp"`` for standalone ones (None -> real
    compute off, roofline timing only).

    ``sched_policy`` is the cluster-wide default batch-composition policy;
    a node's ``@policy`` DSL suffix (``options["sched_policy"]``)
    overrides it per endpoint. ``prefix_cache`` likewise is the
    cluster-wide default for shared-prefix KV reuse, overridden per node
    by the ``@cache`` suffix. ``num_kv_blocks`` overrides every engine's
    device-HBM-derived KV pool size (required with ``executor="paged"``,
    whose pool is materialized for real); ``executor`` names the compute
    backend the factory builds so each EngineConfig records it.

    ``host_kv_blocks`` > 0 adds a host-memory cache tier of that many
    blocks behind every *cached* node's engines; a node's ``@host``
    suffix opts in per node (sized 4x the node's GPU pool when no global
    size is given). ``@host`` on a node without prefix caching raises —
    the tier holds demoted prefix-cache content.
    """
    # imported lazily: core.cronus/baselines import the cluster runtime
    from repro_torch.core.balancer import Balancer
    from repro_torch.core.baselines import PipelineDeviceModel
    from repro_torch.core.cronus import build_cronus, build_disaggregated
    from repro_torch.core.predictor import profile_chunked, profile_prefill

    if isinstance(spec, str):
        spec = parse_cluster_spec(spec)
    executor_factory = executor_factory or _null_factory
    kw = dict(executor_factory=executor_factory, max_slots=max_slots,
              block_size=block_size, max_batched_tokens=max_batched_tokens,
              num_kv_blocks=num_kv_blocks, executor=executor)

    def pool(device) -> int:
        """Per-engine GPU KV pool size (override or HBM-derived)."""
        return (num_kv_blocks if num_kv_blocks is not None
                else max(device.kv_block_budget(block_size), 64))

    def host_tier(node, cache: bool, gpu_pool: int) -> int:
        """Host-tier blocks for a node: @host default 4x the GPU pool,
        global ``host_kv_blocks`` overrides; requires caching."""
        tier = node.options.get("host_tier", False)
        if tier and not cache:
            raise ValueError(
                f"node {node.kind}:{'+'.join(node.devices)}: @host requires "
                "prefix caching (@cache suffix or prefix_cache=True) — the "
                "host tier holds demoted prefix-cache content")
        if not cache or not (tier or host_kv_blocks):
            return 0
        return host_kv_blocks if host_kv_blocks else 4 * gpu_pool

    endpoints: List[Endpoint] = []
    for node in spec.nodes:
        policy = node.options.get("sched_policy", sched_policy)
        cache = node.options.get("prefix_cache", prefix_cache)
        for i in range(node.count):
            name = f"{node.kind}{len(endpoints)}"
            if node.kind in PAIR_KINDS:
                hi_spec, lo_spec = (DEVICES[d] for d in node.devices)
                hi, lo = DeviceModel(hi_spec, cfg), DeviceModel(lo_spec, cfg)
                # host tier sized off the decode-side pool (where the
                # shared-prefix working set actually lives)
                decode_model = lo if node.kind == "disagg_hl" else hi
                host = host_tier(node, cache, pool(decode_model))
                if node.kind == "cronus":
                    bal = Balancer(profile_prefill(lo), profile_chunked(hi))
                    system = build_cronus(
                        cfg, lo, hi, balancer=bal, sched_policy=policy,
                        prefix_cache=cache, host_kv_blocks=host,
                        decode_offload=node.options.get("decode_offload",
                                                        False), **kw)
                elif node.kind == "disagg_lh":
                    system = build_disaggregated(cfg, lo, hi,
                                                 sched_policy=policy,
                                                 prefix_cache=cache,
                                                 host_kv_blocks=host, **kw)
                else:                                   # disagg_hl
                    system = build_disaggregated(cfg, hi, lo,
                                                 sched_policy=policy,
                                                 prefix_cache=cache,
                                                 host_kv_blocks=host, **kw)
                endpoints.append(system.endpoint(name))
            elif node.kind == "pp":
                hi_spec, lo_spec = (DEVICES[d] for d in node.devices)
                device = PipelineDeviceModel(hi_spec, lo_spec, cfg)
                eng = Engine(name, cfg,
                             EngineConfig(
                                 max_batched_tokens=max_batched_tokens,
                                 max_slots=max_slots, block_size=block_size,
                                 num_kv_blocks=pool(device),
                                 sched_policy=policy, prefix_cache=cache,
                                 host_kv_blocks=host_tier(node, cache,
                                                          pool(device)),
                                 executor=executor),
                             device, executor_factory("pp"))
                endpoints.append(WorkerEndpoint(name, eng, queue_cap=None))
            else:                                        # worker
                dev = DeviceModel(DEVICES[node.devices[0]], cfg)
                eng = Engine(name, cfg,
                             EngineConfig(
                                 max_batched_tokens=node.options.get(
                                     "max_batched_tokens", max_batched_tokens),
                                 max_slots=max_slots, block_size=block_size,
                                 num_kv_blocks=pool(dev),
                                 sched_policy=policy, prefix_cache=cache,
                                 host_kv_blocks=host_tier(node, cache,
                                                          pool(dev)),
                                 executor=executor),
                             dev, executor_factory("worker"))
                endpoints.append(WorkerEndpoint(
                    name, eng,
                    queue_cap=node.options.get("queue_cap",
                                               worker_queue_cap)))

    if router is None:
        router = spec.router
    if isinstance(router, str):
        router = make_router(router)
    return ClusterSystem(endpoints=endpoints, router=router)
