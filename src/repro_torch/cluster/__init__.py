"""Cluster runtime: many engines, one event loop, pluggable routing.

Layering (bottom-up):
  * ``repro_torch.core.engine.Engine`` — one serving instance (device +
    executor).
  * ``repro_torch.cluster.runtime.Endpoint`` — a routable unit: a
    standalone worker, or a Cronus PPI+CPI pair
    (``repro_torch.cluster.pair``).
  * ``repro_torch.cluster.runtime.ClusterRuntime`` — the event loop that
    advances the globally-lagging runnable engine and fires timed events
    (arrivals, KV-transfer completions).
  * ``repro_torch.cluster.router`` — picks an endpoint per request.
"""
from repro_torch.cluster.pair import CronusPairEndpoint
from repro_torch.cluster.router import RoundRobinRouter, Router
from repro_torch.cluster.runtime import (ClusterRuntime, Endpoint,
                                         EndpointStats, WorkerEndpoint)

__all__ = [
    "ClusterRuntime", "Endpoint", "EndpointStats", "WorkerEndpoint",
    "CronusPairEndpoint", "Router", "RoundRobinRouter",
]
