"""Load sweep + SLO capacity search over the open-loop driver.

Two measurement shapes on top of :class:`~repro_torch.workloads.driver.
OpenLoopDriver`:

  * :func:`rate_sweep` — latency-vs-QPS curves (the paper's Fig.-4
    shape): run the same workload at each requested rate on a *fresh*
    service and collect TTFT/TBT tails, goodput and queueing delay per
    point.
  * :func:`capacity_search` / :func:`find_capacity` — the number
    operators actually want: the maximum arrival rate a system sustains
    while keeping goodput (SLO attainment) at or above a target.
    Goodput is monotone non-increasing in offered load, so a bracketed
    bisection converges; the search keeps every evaluation so callers
    can plot the probe points.

Both are callable-parameterised (``make_service()`` /
``make_requests(rate)``) so any topology × workload combination sweeps
the same way — benchmarks pass ``ServeSpec(...).build`` and a
``make_trace(..., arrival=f"poisson:{rate}")`` closure.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.metrics import slo_attainment
from repro_torch.core.request import Request
from repro_torch.workloads.driver import OpenLoopDriver

# Latency deadlines for goodput (SLO-attainment) reporting, chosen from the
# paper's Fig. 4 operating range on the Azure-conversation trace: a request
# is "good" if its TTFT and its per-request P99 inter-token gap both land
# under these. (Canonical home of the values benchmarks/common.py
# re-exports.)
DEFAULT_TTFT_SLO = 5.0    # seconds
DEFAULT_TBT_SLO = 0.20    # seconds/token


def open_loop_measure(make_service: Callable[[], object],
                      make_requests: Callable[[float], Sequence[Request]],
                      rate: float, *,
                      ttft_slo: float = DEFAULT_TTFT_SLO,
                      tbt_slo: float = DEFAULT_TBT_SLO,
                      seed: Optional[int] = None) -> Dict[str, float]:
    """One curve point: build a fresh service, drive ``make_requests(rate)``
    open-loop, and return the aggregate with queueing keys, ``goodput``
    (unfinished submissions count as misses) and ``rate``.

    ``seed`` pins probe construction: when given, the trace factory is
    called as ``make_requests(rate, seed)`` so the same (rate, seed) pair
    builds the same request stream in every process — the determinism the
    auto-topology planner's memo relies on. ``None`` keeps the one-arg
    back-compat call."""
    service = make_service()
    reqs = list(make_requests(rate) if seed is None
                else make_requests(rate, seed))
    driver = OpenLoopDriver(service)
    driver.run(reqs)
    m = driver.metrics()
    # goodput over the submitted stream, not just the finished set, so a
    # system that sheds load can't look good by finishing only the easy part
    m["goodput"] = slo_attainment([r.metrics for r in reqs],
                                  ttft_slo, tbt_slo)
    m["rate"] = rate
    return m


def rate_sweep(make_service: Callable[[], object],
               make_requests: Callable[[float], Sequence[Request]],
               rates: Sequence[float], *,
               ttft_slo: float = DEFAULT_TTFT_SLO,
               tbt_slo: float = DEFAULT_TBT_SLO,
               seed: Optional[int] = None) -> List[Dict[str, float]]:
    """Latency-vs-QPS curve: one :func:`open_loop_measure` row per rate."""
    return [open_loop_measure(make_service, make_requests, r,
                              ttft_slo=ttft_slo, tbt_slo=tbt_slo, seed=seed)
            for r in rates]


@dataclasses.dataclass(frozen=True)
class CapacityResult:
    """Outcome of a capacity search. ``rate`` is the highest *probed* rate
    whose goodput met ``target`` (0.0 when even the lower bracket missed);
    ``evaluations`` holds every ``(rate, goodput)`` probe in order."""

    rate: float
    target: float
    evaluations: Tuple[Tuple[float, float], ...]

    @property
    def sustainable(self) -> bool:
        """Whether some probed rate met the target."""
        return self.rate > 0.0


def capacity_search(eval_goodput: Callable[[float], float],
                    lo: float, hi: float, *,
                    target: float = 0.9, rel_tol: float = 0.05,
                    max_iters: int = 12) -> CapacityResult:
    """Largest rate in ``[lo, hi]`` with ``eval_goodput(rate) >= target``.

    Assumes goodput is monotone non-increasing in rate (more offered load
    never helps the tail). Brackets first — a failing ``lo`` returns
    ``rate=0.0`` (nothing in range is sustainable) and a passing ``hi``
    returns ``hi`` (the system out-runs the whole range) — then bisects
    until the bracket is within ``rel_tol`` of the passing edge or
    ``max_iters`` probes are spent. The returned rate was always
    *actually measured* as good, never interpolated.
    """
    if lo <= 0 or hi < lo:
        raise ValueError(f"capacity_search needs 0 < lo <= hi, "
                         f"got [{lo}, {hi}]")
    if not 0.0 < target <= 1.0:
        raise ValueError(f"target must be in (0, 1], got {target}")
    evals: List[Tuple[float, float]] = []

    def probe(rate: float) -> float:
        g = float(eval_goodput(rate))
        evals.append((rate, g))
        return g

    if probe(lo) < target:
        return CapacityResult(0.0, target, tuple(evals))
    if hi == lo or probe(hi) >= target:
        return CapacityResult(hi, target, tuple(evals))
    good, bad = lo, hi
    for _ in range(max_iters):
        if (bad - good) <= rel_tol * good:
            break
        mid = 0.5 * (good + bad)
        if probe(mid) >= target:
            good = mid
        else:
            bad = mid
    return CapacityResult(good, target, tuple(evals))


def find_capacity(make_service: Callable[[], object],
                  make_requests: Callable[[float], Sequence[Request]],
                  lo: float, hi: float, *,
                  target: float = 0.9,
                  ttft_slo: float = DEFAULT_TTFT_SLO,
                  tbt_slo: float = DEFAULT_TBT_SLO,
                  rel_tol: float = 0.05,
                  max_iters: int = 12,
                  seed: Optional[int] = None) -> CapacityResult:
    """SLO-sustainable capacity of one system: :func:`capacity_search`
    with each probe a full open-loop run at that rate. ``seed`` pins
    probe construction (see :func:`open_loop_measure`) so the same
    search on the same system is bit-reproducible."""
    def eval_goodput(rate: float) -> float:
        return open_loop_measure(make_service, make_requests, rate,
                                 ttft_slo=ttft_slo,
                                 tbt_slo=tbt_slo, seed=seed)["goodput"]
    return capacity_search(eval_goodput, lo, hi, target=target,
                           rel_tol=rel_tol, max_iters=max_iters)
