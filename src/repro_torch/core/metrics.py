"""Serving QoE metrics: throughput, TTFT P99, TBT P99 (paper §2, §5),
plus SLO attainment (goodput) for scheduler ablations."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class RequestMetrics:
    """Timestamps and counters recorded for one request."""
    req_id: str
    arrival: float
    input_len: int
    output_len: int
    first_token_time: Optional[float] = None    # absolute time of first token
    token_times: List[float] = dataclasses.field(default_factory=list)
    finish_time: Optional[float] = None
    # absolute time the request first won a KV slot on ANY engine (the PPI
    # prefill view shares this object, so for Cronus it is PPI admission).
    # Recorded unconditionally (inert for the seed aggregates); surfaced
    # only through the opt-in queueing keys the open-loop driver requests.
    service_start_time: Optional[float] = None
    cached_prefix_tokens: int = 0     # prompt tokens served from prefix cache
    # terminal state: a request either finishes (finish_time set) or is
    # cancelled mid-flight (cancelled set, finish_time stays None) —
    # cancelled requests never enter throughput/latency aggregates
    cancelled: bool = False
    cancel_time: Optional[float] = None

    @property
    def ttft(self) -> float:
        """Time to first token."""
        return self.first_token_time - self.arrival

    @property
    def queueing_delay(self) -> Optional[float]:
        """Arrival -> first slot admission on any engine: the part of TTFT
        spent waiting rather than being served. None until admitted."""
        if self.service_start_time is None:
            return None
        return self.service_start_time - self.arrival

    @property
    def tbts(self) -> List[float]:
        """Gaps between consecutive output tokens."""
        ts = [self.first_token_time] + self.token_times
        return [b - a for a, b in zip(ts[:-1], ts[1:])]


def percentile(values, p: float) -> float:
    """``p``-th percentile of ``values`` (NaN when empty)."""
    if not values:
        return float("nan")
    return float(np.percentile(np.asarray(values), p))


def meets_slo(r: RequestMetrics, ttft_slo: float, tbt_slo: float,
              tbt_pct: float = 99.0) -> bool:
    """Did one completed request hit both latency deadlines? TTFT against
    ``ttft_slo``; the per-request P``tbt_pct`` inter-token gap against
    ``tbt_slo`` (a single straggler token shouldn't fail a request whose
    stream was otherwise smooth)."""
    if r.finish_time is None or r.first_token_time is None:
        return False
    if r.ttft > ttft_slo:
        return False
    tbts = r.tbts
    return not tbts or percentile(tbts, tbt_pct) <= tbt_slo


def slo_attainment(reqs: List[RequestMetrics], ttft_slo: float,
                   tbt_slo: float, tbt_pct: float = 99.0) -> float:
    """Goodput: fraction of ALL submitted requests that completed within
    both deadlines (incomplete requests count as misses)."""
    if not reqs:
        return float("nan")
    ok = sum(1 for r in reqs if meets_slo(r, ttft_slo, tbt_slo, tbt_pct))
    return ok / len(reqs)


def aggregate(reqs: List[RequestMetrics],
              ttft_slo: Optional[float] = None,
              tbt_slo: Optional[float] = None,
              queueing: bool = False,
              utilization: Optional[Dict[str, Dict[str, float]]] = None
              ) -> Dict[str, float]:
    """Fleet QoE summary. Passing both SLOs adds a ``goodput`` key;
    ``queueing=True`` (requested only by the open-loop driver) adds the
    queueing/service split of TTFT. ``utilization`` attaches a prebuilt
    per-endpoint breakdown (busy_frac, queued-age max, dispatched count —
    see ``InferenceService.metrics(utilization=True)``) under one
    ``"utilization"`` key. All opt-in: the default call returns exactly
    the seed's dict, so existing run metrics stay bit-identical."""
    done = [r for r in reqs if r.finish_time is not None and not r.cancelled]
    n_cancelled = sum(1 for r in reqs if r.cancelled)
    if not done:
        out = {"throughput": 0.0, "ttft_p99": float("nan"),
               "tbt_p99": float("nan"), "completed": 0}
        if n_cancelled:
            out["cancelled"] = n_cancelled
        if queueing:
            out.update(queueing_p50=float("nan"), queueing_p99=float("nan"),
                       ttft_service_p99=float("nan"))
        if ttft_slo is not None and tbt_slo is not None:
            out["goodput"] = 0.0 if reqs else float("nan")
        if utilization is not None:
            out["utilization"] = utilization
        return out
    t0 = min(r.arrival for r in done)
    t1 = max(r.finish_time for r in done)
    ttfts = [r.ttft for r in done if r.first_token_time is not None]
    tbts = [tbt for r in done for tbt in r.tbts]
    out = {
        "throughput": len(done) / max(t1 - t0, 1e-9),
        "ttft_p50": percentile(ttfts, 50),
        "ttft_p99": percentile(ttfts, 99),
        "tbt_p50": percentile(tbts, 50),
        "tbt_p99": percentile(tbts, 99),
        "completed": len(done),
        "makespan": t1 - t0,
    }
    if n_cancelled:
        # cancellation key appears only when cancels happened, so a
        # cancel-free run's dict stays byte-identical to the seed's
        out["cancelled"] = n_cancelled
    saved = sum(r.cached_prefix_tokens for r in done)
    if saved:
        # Prefix-cache keys appear only when the cache actually hit, so a
        # cache-off run's dict is byte-identical to the seed's. The rate
        # is tokens saved over prompt tokens ingested — a savings ratio,
        # not a probability: cached_prefix_tokens accumulates across the
        # PPI and CPI sides of one Cronus request and across
        # preemption-recompute cycles (whose folded prompts re-share), so
        # it can rarely exceed 1.
        out["prefill_tokens_saved"] = saved
        out["prefix_cache_hit_rate"] = saved / max(
            sum(r.input_len for r in done), 1)
    if queueing:
        # TTFT = queueing (arrival -> first slot) + service (slot -> first
        # token). Opt-in: only the open-loop driver asks, so closed-loop
        # replay dicts stay byte-identical to the seed's.
        qs = [q for r in done if (q := r.queueing_delay) is not None]
        out["queueing_p50"] = percentile(qs, 50)
        out["queueing_p99"] = percentile(qs, 99)
        svc = [r.ttft - r.queueing_delay for r in done
               if r.first_token_time is not None
               and r.queueing_delay is not None]
        out["ttft_service_p99"] = percentile(svc, 99)
    if ttft_slo is not None and tbt_slo is not None:
        out["goodput"] = slo_attainment(reqs, ttft_slo, tbt_slo)
    if utilization is not None:
        out["utilization"] = utilization
    return out
