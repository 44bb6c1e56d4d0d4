"""Open-loop workload subsystem: arrival processes, a live-submission
driver over :class:`~repro_torch.serving.api.InferenceService`, and the rate
sweep / SLO capacity search built on them. See the module docstrings of
:mod:`repro_torch.workloads.arrivals`, :mod:`repro_torch.workloads.driver` and
:mod:`repro_torch.workloads.sweep`."""
from repro_torch.workloads.arrivals import (ARRIVAL_KINDS, ArrivalProcess,
                                      BurstyProcess, DiurnalRamp,
                                      FixedInterval, PoissonProcess,
                                      parse_arrival)
from repro_torch.workloads.driver import OpenLoopDriver
from repro_torch.workloads.sweep import (DEFAULT_TBT_SLO, DEFAULT_TTFT_SLO,
                                   CapacityResult, capacity_search,
                                   find_capacity, open_loop_measure,
                                   rate_sweep)

__all__ = [
    "ARRIVAL_KINDS", "ArrivalProcess", "BurstyProcess", "DiurnalRamp",
    "FixedInterval", "PoissonProcess", "parse_arrival",
    "OpenLoopDriver",
    "DEFAULT_TBT_SLO", "DEFAULT_TTFT_SLO", "CapacityResult",
    "capacity_search", "find_capacity", "open_loop_measure", "rate_sweep",
]
