"""The one traffic generator: requests from a mix's data file and a seed.

A mix (``perfbench/traffic/<name>.json``) gives log-normal prompt and
output lengths (mean, sigma, clip; the sampler of the port's
``serving/trace.py``, log-normal with ``E[x] = mean`` clipped to
``[min, max]``) and either an open loop (``"loop": "open"``) or a closed
loop of ``clients`` (``"loop": "closed"``) that each send their next
request when the last one finished. An open loop's ``arrival`` names its
process, the three of the port's ``workloads/arrivals.py``:

- ``poisson``: ``rate`` requests/s;
- ``burst``: on/off Poisson, ``rate`` on average, ``burstiness`` times it
  in the on phases (mean ``mean_on_s`` seconds) and silent off phases
  (mean ``mean_on_s · (burstiness - 1)``);
- ``ramp``: a rate that swings as a cosine from ``rate_lo`` to
  ``rate_hi`` and back every ``period_s`` seconds, starting at the trough
  when the warm-up starts.

Any other ``arrival`` or ``loop`` is refused, so a new mix needs only its
data file where one of these serves.

Every seed gets the same work in another order: lengths and arrival gaps
are the quantiles of their distributions at ``(i + 1/2) / n``, permuted by
the seed; only the order and the token ids (uniform over the vocabulary)
differ between seeds. An open loop draws one such block of requests for
the warm-up and one for the window, as many as the process's mean rate
gives over the span, each block's gaps scaled to span it exactly, so
every seed's window holds the same lengths and the same arrivals (for
``burst``, the same on and off phases in another order). A closed loop draws blocks of ``BLOCK`` pairs
as clients ask for them, and starts from the loop's steady state: each
client's first request is one in flight, taken in proportion to its
output length, with a uniform share of its output already generated and
folded into its prompt.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

BLOCK = 256


def _lognormal_quantiles(n: int, mean: float, sigma: float, lo: int,
                         hi: int) -> np.ndarray:
    """``n`` stratified draws of the clipped log-normal with mean
    ``mean`` (before clipping), as integers."""
    from statistics import NormalDist
    mu = math.log(mean) - sigma ** 2 / 2.0
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.exp(mu + sigma * z).astype(int), lo, hi)


class Traffic:
    """Request bodies and due times of one mix under one seed."""

    def __init__(self, mix: Dict, seed: int, vocab: int):
        self.mix = mix
        self.vocab = vocab
        self.rng = np.random.default_rng([seed % 2 ** 63, 0x545246])
        self._lengths = iter(())

    @property
    def closed(self) -> bool:
        """Whether the mix is a closed loop of clients."""
        return self.mix["loop"] == "closed"

    def tokens(self, n: int) -> np.ndarray:
        """A prompt of ``n`` token ids."""
        return self.rng.integers(0, self.vocab, n).astype(np.int32)

    def _block(self, n: int):
        """``n`` (prompt, output) pairs: the lengths' ``n`` quantiles,
        each in a fresh order."""
        mix = self.mix
        ins = _lognormal_quantiles(n, mix["mean_in"], mix["sigma_in"],
                                   mix["min_in"], mix["max_in"])
        outs = _lognormal_quantiles(n, mix["mean_out"], mix["sigma_out"],
                                    mix["min_out"], mix["max_out"])
        return [(int(a), int(b)) for a, b in
                zip(self.rng.permutation(ins), self.rng.permutation(outs))]

    def lengths(self) -> Tuple[int, int]:
        """The next (prompt, output) lengths, from blocks of ``BLOCK``."""
        try:
            return next(self._lengths)
        except StopIteration:
            self._lengths = iter(self._block(BLOCK))
            return next(self._lengths)

    def schedule(self, warmup_s: float, seconds: float
                 ) -> List[Tuple[float, int, int]]:
        """Open loop: ``(due, prompt length, output length)`` in due
        order, ``due`` in seconds from the start of the warm-up: a block
        for the warm-up and one for the window, each timed by the mix's
        ``arrival`` process over its span."""
        if self.mix["loop"] != "open":
            raise ValueError(f"schedule needs an open loop, not "
                             f"{self.mix['loop']!r}")
        kind = self.mix["arrival"]
        if kind not in ARRIVALS:
            raise ValueError(f"unknown arrival {kind!r}; known: "
                             f"{sorted(ARRIVALS)}")
        out = []
        for start, span in ((0.0, warmup_s), (warmup_s, seconds)):
            times = ARRIVALS[kind](self, start, span)
            out += [(float(t), a, b)
                    for t, (a, b) in zip(times, self._block(len(times)))]
        return out

    def _unit_times(self, n: int, span: float) -> np.ndarray:
        """``n`` Poisson arrivals that fill ``[0, span)`` exactly: the
        gaps are the exponential's ``n`` quantiles, permuted, scaled to
        ``span``; the first comes at 0."""
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
        gaps = self.rng.permutation(gaps / gaps.sum() * span)
        return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])

    def _poisson(self, start: float, span: float) -> np.ndarray:
        n = max(1, round(float(self.mix["rate"]) * span))
        return start + self._unit_times(n, span)

    def _burst(self, start: float, span: float) -> np.ndarray:
        """Poisson arrivals on the on phases' time alone, laid out on the
        clock with the off phases between: cycles of an on and an off
        phase whose lengths are their exponentials' quantiles, permuted,
        scaled so the cycles fill ``span``."""
        mix = self.mix
        b = float(mix["burstiness"])
        if b < 1:
            raise ValueError(f"burstiness must be >= 1, got {b}")
        n = max(1, round(float(mix["rate"]) * span))
        mean_on = float(mix["mean_on_s"])
        k = max(1, round(span / (mean_on * b)))
        q = -np.log1p(-(np.arange(k) + 0.5) / k)
        on = self.rng.permutation(q) * mean_on
        off = self.rng.permutation(q) * mean_on * (b - 1.0)
        scale = span / (on.sum() + off.sum())
        on, off = on * scale, off * scale
        t_on = self._unit_times(n, float(on.sum()))
        phase = np.searchsorted(np.cumsum(on), t_on, side="right")
        off_before = np.concatenate([[0.0], np.cumsum(off)])
        return start + t_on + off_before[np.minimum(phase, k - 1)]

    def _ramp(self, start: float, span: float) -> np.ndarray:
        """Poisson arrivals under the cosine rate: the unit-rate block
        mapped through the inverse of the rate's integral."""
        mix = self.mix
        lo, hi = float(mix["rate_lo"]), float(mix["rate_hi"])
        period = float(mix["period_s"])
        if not 0 < lo <= hi or period <= 0:
            raise ValueError("ramp needs 0 < rate_lo <= rate_hi and "
                             "period_s > 0")

        def load(t):                    # the rate's integral from 0 to t
            w = 2.0 * math.pi / period
            return lo * t + (hi - lo) * 0.5 * (t - np.sin(w * t) / w)
        grid = np.linspace(start, start + span, 4097)
        cum = load(grid)
        n = max(1, round(float(cum[-1] - cum[0])))
        u = cum[0] + self._unit_times(n, float(cum[-1] - cum[0]))
        return np.interp(u, cum, grid)

    def steady_start(self, clients: int):
        """Closed loop: the first request of each client, as one caught in
        flight: ``(prompt tokens, output length)`` with a share of its
        output already folded into the prompt."""
        pool = [self.lengths() for _ in range(BLOCK)]
        weight = np.array([o for _, o in pool], float)
        idx = self.rng.choice(len(pool), clients, replace=False,
                              p=weight / weight.sum())
        ages = self.rng.permutation((np.arange(clients) + 0.5) / clients)
        out = []
        for i, u in zip(idx, ages):
            n_in, n_out = pool[int(i)]
            done = min(int(u * n_out), n_out - 1)
            out.append((self.tokens(n_in + done), n_out - done))
        self._lengths = iter(())
        return out


ARRIVALS = {"poisson": Traffic._poisson, "burst": Traffic._burst,
            "ramp": Traffic._ramp}
