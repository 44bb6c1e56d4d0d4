"""Live-submission open-loop driver.

``ClusterRuntime.run(trace)`` is a *closed-loop* replay: the whole trace
is pending from step one, so routers and balancers see the future and
queueing never builds up the way it does when requests actually arrive
over time. :class:`OpenLoopDriver` replays the same workload *honestly*:
each request is handed to :meth:`InferenceService.submit` only once
simulated time reaches its arrival, with
:meth:`InferenceService.step_until` advancing the cluster through
everything due strictly before that instant. The request stream is
consumed in order — never pre-sorted, never materialised ahead of the
clock — so the service learns about a request exactly when an online
system would.

Fixed-interval arrivals are the degenerate case: the driver then
reproduces the closed-loop ``run(trace)`` aggregate metrics exactly
(``tests/test_workloads.py`` asserts dict equality), because engine
admission always gated on each request's ``arrival`` anyway — the closed
loop's foreknowledge only ever mattered to cross-request *policy* probes
(load-dependent balancing/routing), which fixed spacing leaves on the
same schedule.

On top of the usual TTFT/TBT aggregates the driver separates *queueing*
from *service*: every request records ``service_start_time`` when it
first wins a KV slot on any engine, and :meth:`OpenLoopDriver.metrics`
opts into the ``queueing_p50`` / ``queueing_p99`` / ``ttft_service_p99``
aggregate keys (closed-loop replays never emit them, keeping their
metric dicts byte-identical to the seed's).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Iterable, List, Optional

from repro_torch.core.request import Request

if TYPE_CHECKING:                  # driver is duck-typed over the service
    from repro_torch.serving.api import InferenceService, RequestHandle


class OpenLoopDriver:
    """Submit a request stream at its wall-time offsets over a built
    :class:`~repro_torch.serving.api.InferenceService`.

    Example::

        service = ServeSpec(approach="cronus").build()
        trace = make_trace(1000, arrival="poisson:6")
        driver = OpenLoopDriver(service)
        driver.run(trace)                  # live submission + drain
        curve_point = driver.metrics(ttft_slo=5.0, tbt_slo=0.2)
    """

    def __init__(self, service: "InferenceService"):
        self.service = service
        self.handles: List["RequestHandle"] = []

    def run(self, requests: Iterable[Request],
            max_steps: int = 10_000_000) -> Dict[str, float]:
        """Drive the stream to completion; returns the same aggregate
        dict ``InferenceService.drain`` produces (use :meth:`metrics`
        for the queueing-separated view).

        ``requests`` must already be in arrival order — arrival
        processes generate monotone timestamps, and sorting here would
        quietly re-introduce the closed loop's future knowledge — so
        out-of-order input is refused loudly instead.
        """
        last: Optional[float] = None
        for req in requests:
            if last is not None and req.arrival < last:
                raise ValueError(
                    f"open-loop submission needs arrival-ordered requests: "
                    f"{req.req_id!r} arrives at {req.arrival:.6f} after one "
                    f"at {last:.6f} (the driver never pre-sorts — sort the "
                    "stream at generation time)")
            last = req.arrival
            # advance through everything due strictly BEFORE this arrival,
            # then submit: a tick at exactly t=arrival runs with the
            # request already pending, matching the closed loop's
            # dispatch-before-advance order within a tick
            self.service.step_until(req.arrival, strict=True)
            self.handles.append(self.service.submit(req))
        return self.service.drain(max_steps)

    def metrics(self, ttft_slo: Optional[float] = None,
                tbt_slo: Optional[float] = None,
                utilization: bool = False) -> Dict[str, float]:
        """Aggregate metrics with the open-loop-only queueing keys
        (``queueing_p50`` / ``queueing_p99`` / ``ttft_service_p99``) and,
        when both SLOs are given, ``goodput``. ``utilization=True``
        passes through the per-endpoint breakdown."""
        return self.service.metrics(ttft_slo, tbt_slo, queueing=True,
                                    utilization=utilization)

    @property
    def n_submitted(self) -> int:
        """Requests submitted so far."""
        return len(self.handles)
