"""Device inventory, endpoint templates, and device-second accounting for
elastic autoscaling.

The scale-up question on a heterogeneous cluster is not just *whether* to
add capacity but *what kind*: an A100+A10 Cronus pair buys ~3.5x the
sustainable QPS of a lone A10 worker at ~3.5x the device cost, so the
right choice depends on the size of the deficit and on what the inventory
still holds. This module supplies the three pieces the policy loop
composes:

  * :class:`DeviceInventory` — counts of idle devices by type (the spare
    rack), with a ``"A100:1,A10:4"`` spec string for CLI/JSON round-trip;
  * :class:`EndpointTemplate` — a buildable endpoint kind (single-node
    topology-DSL string such as ``"cronus:A100+A10"`` or ``"worker:A10"``)
    plus its estimated SLO-sustainable capacity, normally seeded from
    ``repro_torch.workloads.find_capacity`` measurements;
  * :class:`DeviceLedger` — device-seconds per device type, opened at
    scale-up and closed at scale-down, so a benchmark can report SLO
    attainment *per device-second* instead of pretending capacity is free.

Costs are normalized to A100-seconds (``UNIT_COST`` — peak-FLOPS ratio,
the same proxy the paper's §5.1 cost argument uses), so heterogeneous
fleets compare on one axis.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.hardware import DEVICES

# relative cost of one device-second, normalized to the A100 (peak-FLOPS
# ratio — the capability proxy the paper's heterogeneity argument prices)
UNIT_COST: Dict[str, float] = {
    name: spec.flops / DEVICES["A100"].flops for name, spec in DEVICES.items()
}

# heuristic capacity prior: sustainable QPS scales roughly with aggregate
# peak FLOPS for this workload family; the coefficient is calibrated to
# the measured open-loop capacity of the cronus A100+A10 pair
# (~5.8 QPS / 437 TFLOPS — see benchmarks/baselines/BENCH_open_loop.json).
# Templates built from find_capacity measurements override this.
_QPS_PER_TFLOP = 0.013


def heuristic_capacity_qps(devices: Sequence[str]) -> float:
    """FLOPS-proportional capacity prior for a device set (QPS)."""
    return _QPS_PER_TFLOP * sum(DEVICES[d].flops for d in devices) / 1e12


def endpoint_devices(ep) -> Tuple[str, ...]:
    """Device-type names an endpoint occupies (one per engine; the fused
    PP engine runs on both devices of its pipeline)."""
    names: List[str] = []
    for eng in ep.engines:
        dev = eng.device
        spec = getattr(dev, "spec", None)
        if spec is not None:
            names.append(spec.name)
        else:       # PipelineDeviceModel: hi/lo DeviceSpecs, one engine
            for s in (getattr(dev, "hi", None), getattr(dev, "lo", None)):
                if s is not None:
                    names.append(s.name)
    return tuple(names)


@dataclasses.dataclass
class DeviceInventory:
    """Idle devices by type — what the autoscaler may still turn into
    endpoints. Mutated by ``take``/``put`` as endpoints attach/detach."""

    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for name, n in self.counts.items():
            if name not in DEVICES:
                raise ValueError(f"unknown device {name!r} in inventory; "
                                 f"choose from {sorted(DEVICES)}")
            if n < 0:
                raise ValueError(f"negative inventory count for {name!r}")
        self.counts = {k: v for k, v in self.counts.items() if v > 0}

    @classmethod
    def parse(cls, spec: str) -> "DeviceInventory":
        """``"A100:1,A10:4"`` -> inventory. Empty string = empty rack."""
        counts: Dict[str, int] = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            dev, sep, n = part.partition(":")
            if not sep:
                raise ValueError(f"bad inventory entry {part!r} "
                                 "(expected DEVICE:COUNT)")
            try:
                count = int(n)
            except ValueError:
                raise ValueError(f"bad inventory count in {part!r}") from None
            counts[dev] = counts.get(dev, 0) + count
        return cls(counts)

    @property
    def spec(self) -> str:
        """The inventory as a spec string (``parse`` round-trips it)."""
        return ",".join(f"{d}:{n}" for d, n in sorted(self.counts.items()))

    @property
    def total(self) -> int:
        """Idle devices of every type."""
        return sum(self.counts.values())

    def can_build(self, devices: Sequence[str]) -> bool:
        """Whether the idle devices cover ``devices``."""
        need: Dict[str, int] = {}
        for d in devices:
            need[d] = need.get(d, 0) + 1
        return all(self.counts.get(d, 0) >= n for d, n in need.items())

    def take(self, devices: Sequence[str]) -> None:
        """Remove ``devices`` from the idle pool (they attach)."""
        if not self.can_build(devices):
            raise ValueError(f"inventory {self.spec!r} cannot supply "
                             f"{tuple(devices)}")
        for d in devices:
            self.counts[d] -= 1
        self.counts = {k: v for k, v in self.counts.items() if v > 0}

    def put(self, devices: Sequence[str]) -> None:
        """Return ``devices`` to the idle pool (they detached)."""
        for d in devices:
            if d not in DEVICES:
                raise ValueError(f"unknown device {d!r}")
            self.counts[d] = self.counts.get(d, 0) + 1


@dataclasses.dataclass(frozen=True)
class EndpointTemplate:
    """A buildable endpoint kind: one single-node topology-DSL string
    (``"cronus:A100+A10"``, ``"worker:A10@sarathi"``, ...) plus its
    estimated SLO-sustainable capacity. ``capacity_qps`` should come from
    :func:`repro_torch.workloads.find_capacity` runs on the target workload;
    the FLOPS-proportional heuristic is the fallback prior."""

    node: str
    capacity_qps: float

    def __post_init__(self):
        if self.capacity_qps <= 0:
            raise ValueError(f"template {self.node!r} needs "
                             f"capacity_qps > 0, got {self.capacity_qps}")
        self._node_spec()       # raises on malformed node strings

    def _node_spec(self):
        from repro_torch.cluster.topology import parse_cluster_spec
        spec = parse_cluster_spec(self.node)
        if len(spec.nodes) != 1 or spec.nodes[0].count != 1:
            raise ValueError(f"endpoint template needs exactly one node, "
                             f"got {self.node!r}")
        return spec.nodes[0]

    @property
    def kind(self) -> str:
        """Node kind of the template's endpoint."""
        return self._node_spec().kind

    @property
    def devices(self) -> Tuple[str, ...]:
        """Device names the endpoint consumes."""
        node = self._node_spec()
        # the fused pp engine still occupies both devices
        return node.devices

    @property
    def cost_rate(self) -> float:
        """A100-equivalents this template burns per second attached."""
        return sum(UNIT_COST[d] for d in self.devices)

    @property
    def efficiency(self) -> float:
        """Capacity per A100-equivalent device-second — the ranking the
        scale-up decision optimizes when several templates would cover
        the deficit."""
        return self.capacity_qps / self.cost_rate


def default_templates(
        inventory: DeviceInventory,
        capacity_qps: Optional[Dict[str, float]] = None,
) -> List[EndpointTemplate]:
    """Template set derivable from an inventory: one standalone worker per
    device type, plus a Cronus pair of (fastest type, each slower type) —
    the paper's partially-disaggregated unit. ``capacity_qps`` maps node
    strings to measured capacities and overrides the FLOPS prior."""
    capacity_qps = capacity_qps or {}

    def cap(node: str, devices: Sequence[str]) -> float:
        return capacity_qps.get(node, heuristic_capacity_qps(devices))

    types = sorted(inventory.counts, key=lambda d: -DEVICES[d].flops)
    templates = [EndpointTemplate(f"worker:{t}", cap(f"worker:{t}", (t,)))
                 for t in types]
    hi = types[0] if types else None
    for lo in types[1:]:
        node = f"cronus:{hi}+{lo}"
        templates.append(EndpointTemplate(node, cap(node, (hi, lo))))
    return templates


def build_endpoint(cfg, node: str, name: str, *,
                   executor_factory: Optional[Callable] = None,
                   max_slots: int = 256, block_size: int = 16,
                   max_batched_tokens: int = 512,
                   sched_policy: str = "fcfs", prefix_cache: bool = False,
                   worker_queue_cap: Optional[int] = 4,
                   num_kv_blocks: Optional[int] = None,
                   host_kv_blocks: int = 0,
                   executor: str = "null"):
    """Materialise one endpoint from a single-node topology-DSL string,
    under a caller-chosen unique ``name`` (the builder's positional
    ``kind0`` names would collide with the live cluster's)."""
    from repro_torch.cluster.topology import build_cluster
    system = build_cluster(
        cfg, node, executor_factory=executor_factory, max_slots=max_slots,
        block_size=block_size, max_batched_tokens=max_batched_tokens,
        sched_policy=sched_policy, prefix_cache=prefix_cache,
        worker_queue_cap=worker_queue_cap,
        num_kv_blocks=num_kv_blocks, host_kv_blocks=host_kv_blocks,
        executor=executor)
    (ep,) = system.endpoints
    ep.name = name
    return ep


class DeviceLedger:
    """Device-seconds per device type, accrued from the moment an
    endpoint's devices are committed (scale-up request) until they return
    to the rack (detach). ``finalize``/``report`` price still-open leases
    up to ``now``, so a run's cost is exact at any probe time."""

    def __init__(self):
        self._open: Dict[str, Tuple[Tuple[str, ...], float]] = {}
        self._closed: List[Tuple[Tuple[str, ...], float, float]] = []

    def open(self, name: str, devices: Sequence[str], t: float) -> None:
        """Start a lease on ``devices`` for endpoint ``name`` at ``t``."""
        if name in self._open:
            raise ValueError(f"ledger already has an open lease for "
                             f"{name!r}")
        self._open[name] = (tuple(devices), t)

    def close(self, name: str, t: float) -> None:
        """End endpoint ``name``'s lease at ``t``."""
        devices, t0 = self._open.pop(name)
        self._closed.append((devices, t0, t))

    def device_seconds(self, now: float) -> Dict[str, float]:
        """Leased device-seconds per device type up to ``now``."""
        out: Dict[str, float] = {}
        leases = self._closed + [(d, t0, max(now, t0))
                                 for d, t0 in self._open.values()]
        for devices, t0, t1 in leases:
            for d in devices:
                out[d] = out.get(d, 0.0) + (t1 - t0)
        return out

    def device_cost(self, now: float) -> float:
        """Total A100-equivalent device-seconds up to ``now``."""
        return sum(UNIT_COST[d] * s
                   for d, s in self.device_seconds(now).items())
