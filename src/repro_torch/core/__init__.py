"""The paper's primary contribution: partially disaggregated prefill —
balancer (Alg. 1), execution-time predictors (Eq. 1-3), the continuous-
batching engines, the Cronus orchestrator, and the four baselines."""
from repro_torch.core.balancer import Balancer, CPIStats
from repro_torch.core.cronus import (CronusSystem, FixedBalancer,
                                     build_cronus, build_disaggregated)
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.request import ReqState, Request

__all__ = [
    "Balancer", "CPIStats", "CronusSystem", "FixedBalancer",
    "build_cronus", "build_disaggregated", "Engine", "EngineConfig",
    "ReqState", "Request",
]
