"""Cluster runtime: many engines, one event loop, pluggable routing.

Layering (bottom-up):
  * ``repro_torch.core.engine.Engine`` — one serving instance (device + executor).
  * ``repro_torch.cluster.runtime.Endpoint`` — a routable unit: a standalone
    worker, or a Cronus PPI+CPI pair (``repro_torch.cluster.pair``).
  * ``repro_torch.cluster.runtime.ClusterRuntime`` — the event loop that advances
    the globally-lagging runnable engine and fires timed events (arrivals,
    KV-transfer completions).
  * ``repro_torch.cluster.router`` — picks an endpoint per request (round-robin,
    least-loaded, session-affinity, prefix-affinity).
  * ``repro_torch.cluster.topology`` — builds a whole heterogeneous cluster from
    a declarative spec such as ``"2xcronus:A100+A10,4xworker:A10"``.
"""
from repro_torch.cluster.pair import CronusPairEndpoint
from repro_torch.cluster.router import (LeastLoadedRouter, PrefixAffinityRouter,
                                  Router, RoundRobinRouter,
                                  SessionAffinityRouter, make_router)
from repro_torch.cluster.runtime import (ClusterRuntime, Endpoint, EndpointStats,
                                   WorkerEndpoint)
from repro_torch.cluster.topology import (ClusterSpec, ClusterSystem, NodeSpec,
                                    build_cluster, canonical_cluster_spec,
                                    parse_cluster_spec)

__all__ = [
    "ClusterRuntime", "Endpoint", "EndpointStats", "WorkerEndpoint",
    "CronusPairEndpoint",
    "Router", "RoundRobinRouter", "LeastLoadedRouter",
    "SessionAffinityRouter", "PrefixAffinityRouter", "make_router",
    "ClusterSpec", "NodeSpec", "ClusterSystem", "build_cluster",
    "parse_cluster_spec", "canonical_cluster_spec",
]
