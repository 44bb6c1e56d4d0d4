"""Arrival processes for open-loop workload generation.

The paper's headline numbers are *tail* claims — TTFT P99 / TBT P99 under
a controlled request rate (§5, Fig. 4) — and tails only form when arrivals
are allowed to queue the way real traffic does. An :class:`ArrivalProcess`
turns "n requests" into "n arrival timestamps" under a named traffic
model, deterministically per seed, and composes with the log-normal
length samplers in :mod:`repro_torch.serving.trace` (lengths and arrivals draw
from independent rng streams, so switching the arrival model never
changes the request bodies).

Four models cover the evaluation space:

  * :class:`FixedInterval` — the seed's ``i * interval`` assignment
    (``interval=0`` = everything at t0, the max-throughput degenerate
    case). Consumes no randomness, so traces built through it are
    byte-identical to the historical ``interval=`` path.
  * :class:`PoissonProcess` — memoryless open-loop load at a target QPS,
    the paper's rate-swept setting.
  * :class:`BurstyProcess` — Markov-modulated on/off Poisson: ON phases
    at ``burstiness`` times the long-run rate alternate with silent OFF
    phases, exposing schedulers to queue build-up that a smooth Poisson
    stream of the same average rate never produces.
  * :class:`DiurnalRamp` — sinusoidal rate between ``rate_lo`` and
    ``rate_hi`` (thinning construction), a slow load swing for
    autoscaling experiments.

String specs (CLI / ``ServeSpec.arrival``) round-trip through
:func:`parse_arrival`::

    fixed:INTERVAL
    poisson:RATE
    burst:RATE[:BURSTINESS[:MEAN_ON]]
    ramp:RATE_LO:RATE_HI[:PERIOD]
"""
from __future__ import annotations

import abc
import dataclasses
import math
from typing import Union

import numpy as np

RngLike = Union[int, np.random.Generator]


def _as_rng(rng: RngLike) -> np.random.Generator:
    if isinstance(rng, np.random.Generator):
        return rng
    return np.random.default_rng(rng)


class ArrivalProcess(abc.ABC):
    """A traffic model: ``times(n, rng)`` -> n non-decreasing arrival
    timestamps (seconds, starting near 0). Deterministic for a given
    seed/generator state."""

    kind: str = "?"

    @abc.abstractmethod
    def times(self, n: int, rng: RngLike = 0) -> np.ndarray:
        """n sorted arrival times >= 0 as float64."""

    @property
    @abc.abstractmethod
    def spec(self) -> str:
        """Round-trippable string form (``parse_arrival(p.spec) == p``)."""

    @property
    @abc.abstractmethod
    def mean_rate(self) -> float:
        """Long-run average arrival rate (req/s); ``inf`` for fixed:0."""

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.spec!r})"


@dataclasses.dataclass(frozen=True, repr=False)
class FixedInterval(ArrivalProcess):
    """``i * interval`` — the seed's deterministic spacing. ``interval=0``
    puts every request at t0 (max-throughput closed-loop replay)."""

    interval: float = 0.0
    kind = "fixed"

    def __post_init__(self):
        if self.interval < 0:
            raise ValueError("fixed arrival needs interval >= 0, "
                             f"got {self.interval}")

    def times(self, n: int, rng: RngLike = 0) -> np.ndarray:
        """Arrival ``i`` at ``i * interval``; consumes no randomness."""
        # consumes no randomness: traces built through FixedInterval are
        # byte-identical to the historical `arrival = i * interval`
        return np.arange(n, dtype=np.float64) * self.interval

    @property
    def spec(self) -> str:
        """The process as a spec string."""
        return f"fixed:{self.interval!r}"

    @property
    def mean_rate(self) -> float:
        """Requests per second."""
        return 1.0 / self.interval if self.interval > 0 else math.inf


@dataclasses.dataclass(frozen=True, repr=False)
class PoissonProcess(ArrivalProcess):
    """Memoryless arrivals at ``rate`` req/s (exponential interarrivals)."""

    rate: float
    kind = "poisson"

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"poisson arrival needs rate > 0, got {self.rate}")

    def times(self, n: int, rng: RngLike = 0) -> np.ndarray:
        """Cumulative exponential gaps at ``rate``."""
        rng = _as_rng(rng)
        return np.cumsum(rng.exponential(1.0 / self.rate, n))

    @property
    def spec(self) -> str:
        """The process as a spec string."""
        return f"poisson:{self.rate!r}"

    @property
    def mean_rate(self) -> float:
        """Requests per second."""
        return self.rate


@dataclasses.dataclass(frozen=True, repr=False)
class BurstyProcess(ArrivalProcess):
    """Markov-modulated on/off Poisson: exponential ON phases (mean
    ``mean_on`` s) fire at ``rate * burstiness``; exponential OFF phases
    (mean ``mean_on * (burstiness - 1)``) are silent, so the long-run
    average is exactly ``rate`` while the instantaneous load the
    scheduler faces is ``burstiness`` times higher."""

    rate: float
    burstiness: float = 4.0
    mean_on: float = 5.0
    kind = "burst"

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"burst arrival needs rate > 0, got {self.rate}")
        if self.burstiness < 1:
            raise ValueError("burst arrival needs burstiness >= 1 "
                             f"(peak-to-mean ratio), got {self.burstiness}")
        if self.mean_on <= 0:
            raise ValueError(f"burst arrival needs mean_on > 0, "
                             f"got {self.mean_on}")

    def times(self, n: int, rng: RngLike = 0) -> np.ndarray:
        """Poisson arrivals inside exponential ON phases."""
        rng = _as_rng(rng)
        if self.burstiness == 1.0:           # degenerate: plain Poisson
            return np.cumsum(rng.exponential(1.0 / self.rate, n))
        rate_on = self.rate * self.burstiness
        mean_off = self.mean_on * (self.burstiness - 1.0)
        out = np.empty(n, dtype=np.float64)
        i, t = 0, 0.0
        while i < n:
            on_end = t + rng.exponential(self.mean_on)
            while i < n:
                t += rng.exponential(1.0 / rate_on)
                if t >= on_end:
                    break                     # overshoot discarded (memoryless)
                out[i] = t
                i += 1
            t = on_end + rng.exponential(mean_off)
        return out

    @property
    def spec(self) -> str:
        """The process as a spec string."""
        return (f"burst:{self.rate!r}:{self.burstiness!r}"
                f":{self.mean_on!r}")

    @property
    def mean_rate(self) -> float:
        """Long-run requests per second."""
        return self.rate


@dataclasses.dataclass(frozen=True, repr=False)
class DiurnalRamp(ArrivalProcess):
    """Sinusoidal rate swing between ``rate_lo`` and ``rate_hi`` with
    period ``period`` seconds (starts at the trough), generated by
    thinning a ``rate_hi`` Poisson majorant."""

    rate_lo: float
    rate_hi: float
    period: float = 60.0
    kind = "ramp"

    def __post_init__(self):
        if self.rate_lo <= 0 or self.rate_hi < self.rate_lo:
            raise ValueError("ramp arrival needs 0 < rate_lo <= rate_hi, "
                             f"got {self.rate_lo}..{self.rate_hi}")
        if self.period <= 0:
            raise ValueError(f"ramp arrival needs period > 0, "
                             f"got {self.period}")

    def rate_at(self, t: float) -> float:
        """Instantaneous rate at time ``t``."""
        phase = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / self.period))
        return self.rate_lo + (self.rate_hi - self.rate_lo) * phase

    def times(self, n: int, rng: RngLike = 0) -> np.ndarray:
        """Arrivals thinned from a Poisson process at the peak rate."""
        rng = _as_rng(rng)
        out = np.empty(n, dtype=np.float64)
        i, t = 0, 0.0
        while i < n:
            t += rng.exponential(1.0 / self.rate_hi)
            if rng.random() * self.rate_hi <= self.rate_at(t):
                out[i] = t
                i += 1
        return out

    @property
    def spec(self) -> str:
        """The process as a spec string."""
        return (f"ramp:{self.rate_lo!r}:{self.rate_hi!r}"
                f":{self.period!r}")

    @property
    def mean_rate(self) -> float:
        """Mean requests per second over a period."""
        return 0.5 * (self.rate_lo + self.rate_hi)


ARRIVAL_KINDS = ("fixed", "poisson", "burst", "ramp")

_ARG_RANGES = {"fixed": (1, 1), "poisson": (1, 1),
               "burst": (1, 3), "ramp": (2, 3)}
_BUILDERS = {"fixed": FixedInterval, "poisson": PoissonProcess,
             "burst": BurstyProcess, "ramp": DiurnalRamp}


def parse_arrival(spec: Union[str, ArrivalProcess]) -> ArrivalProcess:
    """``"poisson:4"`` -> :class:`PoissonProcess(rate=4)`, etc. Accepts an
    already-built process unchanged. Raises ``ValueError`` with the
    offending spec on any malformed input."""
    if isinstance(spec, ArrivalProcess):
        return spec
    kind, _, rest = spec.partition(":")
    if kind not in _BUILDERS:
        raise ValueError(f"unknown arrival process {kind!r} in {spec!r}; "
                         f"choose from {ARRIVAL_KINDS}")
    parts = rest.split(":") if rest else []
    try:
        args = [float(p) for p in parts]
    except ValueError:
        raise ValueError(f"bad arrival spec {spec!r}: "
                         "non-numeric parameter") from None
    lo, hi = _ARG_RANGES[kind]
    if not lo <= len(args) <= hi:
        want = str(lo) if lo == hi else f"{lo}..{hi}"
        raise ValueError(f"bad arrival spec {spec!r}: {kind} takes "
                         f"{want} parameter(s), got {len(args)}")
    return _BUILDERS[kind](*args)
