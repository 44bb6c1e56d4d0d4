"""SLO-driven autoscaling policy for the live serving cluster.

The :class:`Autoscaler` closes the loop the paper leaves to operators:
given a rack of idle devices (:class:`~repro_torch.autoscale.inventory
.DeviceInventory`) and the live cluster's windowed signals, decide each
tick window whether to attach a new endpoint, detach an idle one, or hold
— and, because the rack is heterogeneous, *which kind* of endpoint to
build (an A100+A10 Cronus pair vs a lone A10 worker), ranked by measured
SLO-sustainable capacity per A100-equivalent device-second.

Signals (all windowed, none global):

  * **queueing age** — the oldest queued request's age across endpoint
    queues and the service's pending deque. Age is the *leading* overload
    indicator: it crosses ``up_age`` several seconds before TTFT-misses
    show up in finished-request goodput.
  * **windowed goodput** — SLO attainment over requests that finished in
    the last ``window`` seconds; the trailing confirmation, and the guard
    that blocks scale-down while the SLO is in jeopardy.
  * **busy fraction** — per-endpoint work-per-wallclock over the last
    window (``EndpointStats.busy_frac``); the scale-down trigger.
  * **arrival rate** — submissions over the last window, used to size the
    capacity deficit at scale-up and the safety margin at scale-down.

Actuation goes through the membership surface this PR adds
(``attach_endpoint`` / ``detach_endpoint``): scale-down drains residents
by recompute back into the service's pending queue, so no request is ever
lost to a scaling action. Hysteresis comes from three places — distinct
up/down thresholds, a ``cooldown`` after every action, and the rule that
scale-down needs *both* idle busy-fractions and rate headroom.

Policies parse from compact spec strings (``"slo:goodput>=0.9:
cooldown=5"``) so they survive ServeSpec JSON/CLI round-trips.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.metrics import meets_slo
from repro_torch.workloads.sweep import DEFAULT_TBT_SLO, DEFAULT_TTFT_SLO
from repro_torch.autoscale.inventory import (DeviceInventory, DeviceLedger,
                                       EndpointTemplate, build_endpoint,
                                       endpoint_devices,
                                       heuristic_capacity_qps)


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Thresholds and pacing for the scaling loop. Defaults are tuned for
    the repo's simulated-hardware scale (TTFT SLO 5s): react to ~half an
    SLO of queueing, confirm idleness over a 10s window, and never act
    twice within a cooldown."""

    goodput_target: float = 0.9     # windowed SLO-attainment floor
    cooldown: float = 10.0          # min seconds between scaling actions
    window: float = 10.0            # signal window (rate/goodput/busy)
    up_age: float = 2.5             # oldest-queued age triggering scale-up
    down_busy: float = 0.35         # busy-fraction ceiling for scale-down
    down_headroom: float = 0.8      # post-detach capacity safety margin
    min_endpoints: int = 1          # never detach below this floor
    eval_every: float = 1.0         # min seconds between evaluations
    spinup: float = 0.0             # provisioning delay for new endpoints
    ttft_slo: float = DEFAULT_TTFT_SLO
    tbt_slo: float = DEFAULT_TBT_SLO

    def __post_init__(self):
        if not (0.0 < self.goodput_target <= 1.0):
            raise ValueError(f"goodput target must be in (0, 1], "
                             f"got {self.goodput_target}")
        if not (0.0 <= self.down_busy < 1.0):
            raise ValueError(f"down_busy must be in [0, 1), "
                             f"got {self.down_busy}")
        if not (0.0 < self.down_headroom <= 1.0):
            raise ValueError(f"down_headroom must be in (0, 1], "
                             f"got {self.down_headroom}")
        if self.min_endpoints < 1:
            raise ValueError("min_endpoints must be >= 1")
        for field in ("cooldown", "window", "up_age", "eval_every",
                      "spinup", "ttft_slo", "tbt_slo"):
            if getattr(self, field) < 0:
                raise ValueError(f"{field} must be >= 0")

    @property
    def spec(self) -> str:
        """Compact spec string; ``parse_autoscale(p.spec) == p``."""
        default = AutoscalePolicy()
        parts = ["slo"]
        if self.goodput_target != default.goodput_target:
            parts.append(f"goodput>={self.goodput_target!r}")
        for key, field in _POLICY_KEYS.items():
            if getattr(self, field) != getattr(default, field):
                parts.append(f"{key}={getattr(self, field)!r}")
        return ":".join(parts)


# spec-string key -> policy field (goodput>= handled separately)
_POLICY_KEYS = {
    "cooldown": "cooldown",
    "window": "window",
    "up_age": "up_age",
    "down_busy": "down_busy",
    "down_headroom": "down_headroom",
    "min": "min_endpoints",
    "eval": "eval_every",
    "spinup": "spinup",
    "ttft": "ttft_slo",
    "tbt": "tbt_slo",
}


def parse_autoscale(spec: str) -> AutoscalePolicy:
    """Parse ``"slo[:goodput>=G][:cooldown=C][:window=W][:up_age=A]
    [:down_busy=B][:down_headroom=H][:min=N][:eval=E][:spinup=S]
    [:ttft=T][:tbt=T]"``. Only the ``slo`` family exists today; the kind
    prefix keeps room for others (schedule-driven, predictive)."""
    parts = spec.split(":")
    if not parts or parts[0] != "slo":
        raise ValueError(f"unknown autoscale policy kind in {spec!r} "
                         "(expected 'slo[:key=value...]')")
    kw: Dict[str, object] = {}
    for part in parts[1:]:
        if not part:
            raise ValueError(f"empty clause in autoscale spec {spec!r}")
        if part.startswith("goodput>="):
            key, field, raw = "goodput>=", "goodput_target", part[9:]
        else:
            key, sep, raw = part.partition("=")
            if not sep or key not in _POLICY_KEYS:
                raise ValueError(
                    f"bad autoscale clause {part!r}; known keys: "
                    f"goodput>=, {', '.join(sorted(_POLICY_KEYS))}")
            field = _POLICY_KEYS[key]
        try:
            val = int(raw) if field == "min_endpoints" else float(raw)
        except ValueError:
            raise ValueError(f"bad number {raw!r} for autoscale key "
                             f"{key!r}") from None
        if field in kw:
            raise ValueError(f"duplicate autoscale key {key!r} in {spec!r}")
        kw[field] = val
    return AutoscalePolicy(**kw)


class Autoscaler:
    """The scaling loop. Bound to one ``InferenceService`` via
    ``service.attach_autoscaler(autoscaler)``; the service calls
    ``on_tick`` after every simulation tick, and the autoscaler throttles
    itself to ``policy.eval_every`` of simulated time.

    ``endpoint_factory(template, name) -> endpoint`` may be injected for
    tests; the default materialises the template's node string through
    ``build_endpoint`` with the config captured at bind time."""

    def __init__(self, inventory: DeviceInventory,
                 templates: Optional[List[EndpointTemplate]] = None,
                 policy: Optional[AutoscalePolicy] = None,
                 endpoint_factory: Optional[Callable] = None):
        self.inventory = inventory
        self.templates = templates
        self.policy = policy or AutoscalePolicy()
        self.ledger = DeviceLedger()
        self.events: List[Dict] = []     # scaling-action audit trail
        self._factory = endpoint_factory
        self._service = None
        self._capacity: Dict[str, float] = {}    # endpoint name -> QPS est
        self._devices: Dict[str, Tuple[str, ...]] = {}
        self._last_eval = float("-inf")
        self._last_action = float("-inf")
        self._n_added = 0
        self._rate_log: List[Tuple[float, int]] = []  # (now, n_submitted)

    # ------------------------------------------------------------------
    def bind(self, service) -> None:
        """Adopt the service's base fleet: open ledger leases at t=0 and
        seed capacity estimates (template match by device set, else the
        FLOPS prior) so the very first deficit computation is sane."""
        if self._service is not None and self._service is not service:
            raise ValueError("autoscaler is already bound to a service")
        self._service = service
        if self.templates is None:
            from repro_torch.autoscale.inventory import default_templates
            self.templates = default_templates(self.inventory)
        by_devices = {tuple(sorted(t.devices)): t.capacity_qps
                      for t in self.templates}
        for ep in service.runtime.endpoints:
            devices = endpoint_devices(ep)
            self._devices[ep.name] = devices
            self._capacity[ep.name] = by_devices.get(
                tuple(sorted(devices)), heuristic_capacity_qps(devices))
            self.ledger.open(ep.name, devices, 0.0)

    def _build(self, template: EndpointTemplate, name: str):
        if self._factory is not None:
            return self._factory(template, name)
        return build_endpoint(self._service.cfg, template.node, name,
                              **self._service.build_kw)

    # ------------------------------------------------------------------
    def on_tick(self, service) -> Optional[str]:
        """Throttled evaluation; returns the name of the endpoint a
        scaling action touched, or None."""
        now = service.now
        if now - self._last_eval < self.policy.eval_every:
            return None
        self._last_eval = now
        return self.evaluate(service, now)

    # -- signals -------------------------------------------------------
    def _arrival_rate(self, service, now: float) -> float:
        self._rate_log.append((now, service.n_submitted))
        horizon = now - self.policy.window
        while len(self._rate_log) > 2 and self._rate_log[1][0] <= horizon:
            self._rate_log.pop(0)
        t0, n0 = self._rate_log[0]
        span = now - t0
        return (service.n_submitted - n0) / span if span > 0 else 0.0

    def _windowed_goodput(self, service, now: float
                          ) -> Tuple[Optional[float], int]:
        lo = now - self.policy.window
        recent = [r.metrics for ep in service.runtime.endpoints
                  for r in ep.finished() if r.metrics.finish_time >= lo]
        recent += [r.metrics for r in service.runtime.retired
                   if r.metrics.finish_time >= lo]
        if not recent:
            return None, 0
        ok = sum(meets_slo(m, self.policy.ttft_slo, self.policy.tbt_slo)
                 for m in recent)
        return ok / len(recent), len(recent)

    # -- the decision --------------------------------------------------
    def evaluate(self, service, now: float) -> Optional[str]:
        """The policy's decision at ``now``: an action, or None."""
        pol = self.policy
        rate = self._arrival_rate(service, now)   # must sample every eval
        if now - self._last_action < pol.cooldown:
            return None
        endpoints = service.runtime.endpoints
        stats = {ep.name: ep.stats() for ep in endpoints}
        max_age = max([s.oldest_queued_age for s in stats.values()],
                      default=0.0)
        head = service.oldest_pending_arrival()
        if head is not None:
            max_age = max(max_age, now - head)
        goodput, n_recent = self._windowed_goodput(service, now)
        capacity = sum(self._capacity.get(ep.name, 0.0) for ep in endpoints)

        slo_risk = (goodput is not None and n_recent >= 5
                    and goodput < pol.goodput_target)
        if max_age > pol.up_age or slo_risk:
            return self._scale_up(service, now, rate, capacity, max_age)

        idle = (max_age == 0.0 and head is None
                and (goodput is None or goodput >= pol.goodput_target))
        if idle and len(endpoints) > pol.min_endpoints:
            return self._scale_down(service, now, rate, capacity, stats)
        return None

    def _scale_up(self, service, now: float, rate: float,
                  capacity: float, max_age: float) -> Optional[str]:
        deficit = max(rate - capacity, 0.0)
        affordable = [t for t in self.templates
                      if self.inventory.can_build(t.devices)]
        if not affordable:
            return None
        covering = [t for t in affordable if t.capacity_qps >= deficit]
        if covering:
            # cheapest build that plugs the gap; capacity-per-cost breaks
            # ties among equally-priced options
            tpl = min(covering, key=lambda t: (t.cost_rate, -t.efficiency))
        else:
            # nothing covers the whole deficit: take the biggest step
            tpl = max(affordable, key=lambda t: t.capacity_qps)
        name = f"as{self._n_added}-{tpl.kind}"
        self._n_added += 1
        ep = self._build(tpl, name)
        self.inventory.take(tpl.devices)
        # lease opens at decision time (devices are committed now);
        # capacity arrives after the provisioning delay
        self.ledger.open(name, tpl.devices, now)
        service.attach_endpoint(ep, now=now + self.policy.spinup)
        self._devices[name] = tpl.devices
        self._capacity[name] = tpl.capacity_qps
        self._last_action = now
        self._event(dict(t=now, action="scale_up", endpoint=name,
                         node=tpl.node, rate=rate,
                         capacity=capacity, max_age=max_age))
        return name

    def _scale_down(self, service, now: float, rate: float,
                    capacity: float, stats: Dict) -> Optional[str]:
        pol = self.policy
        # candidates: endpoints idle enough to shed; never the last
        # `min_endpoints`, and prefer shedding the least-busy
        order = sorted(service.runtime.endpoints,
                       key=lambda ep: (stats[ep.name].busy_frac,
                                       -self._capacity.get(ep.name, 0.0)))
        for ep in order:
            s = stats[ep.name]
            if s.busy_frac >= pol.down_busy or s.queue_depth > 0:
                continue
            remaining = capacity - self._capacity.get(ep.name, 0.0)
            if rate > pol.down_headroom * remaining:
                continue        # detaching would leave too little margin
            service.detach_endpoint(ep.name)
            devices = self._devices.pop(ep.name)
            self._capacity.pop(ep.name, None)
            self.inventory.put(devices)
            self.ledger.close(ep.name, now)
            self._last_action = now
            self._event(dict(t=now, action="scale_down",
                             endpoint=ep.name, rate=rate,
                             capacity=capacity,
                             busy_frac=s.busy_frac))
            return ep.name
        return None

    def _event(self, event: Dict) -> None:
        """Record one scaling action: on the flight recorder's control
        track when tracing is on (the unified event schema — autoscale
        actions land beside submits/routes/attaches on the timeline),
        and always on the legacy ``events`` list, which ``report()``
        exposes as the compatibility view."""
        self.events.append(event)
        svc = self._service
        tracer = svc.runtime.tracer if svc is not None else None
        if tracer is not None:
            args = {k: v for k, v in event.items()
                    if k not in ("t", "action")}
            tracer.instant(tracer.control, event["action"], event["t"],
                           args, cat="autoscale")

    # ------------------------------------------------------------------
    def report(self, now: Optional[float] = None) -> Dict:
        """Cost + action summary for benchmarks: device-seconds by type,
        A100-equivalent cost, and the scaling audit trail."""
        if now is None:
            now = self._service.now if self._service is not None else 0.0
        return {
            "device_seconds": {
                d: round(s, 6)
                for d, s in sorted(self.ledger.device_seconds(now).items())},
            "device_cost": round(self.ledger.device_cost(now), 6),
            "n_scale_ups": sum(1 for e in self.events
                               if e["action"] == "scale_up"),
            "n_scale_downs": sum(1 for e in self.events
                                 if e["action"] == "scale_down"),
            "final_endpoints": (len(self._service.runtime.endpoints)
                                if self._service is not None else 0),
            "events": list(self.events),
        }
