"""Execution-time predictors (paper §4.4, Eq. 2–3), fitted by linear
regression on profiled data — exactly the paper's methodology. Profiles come
either from the roofline cost model (simulator) or from measured wall times
(real engine on CPU); the balancer is agnostic.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


def _fit_stats(y, yhat):
    y, yhat = np.asarray(y, float), np.asarray(yhat, float)
    ss_res = float(np.sum((y - yhat) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    mape = float(np.mean(np.abs((y - yhat) / np.maximum(np.abs(y), 1e-12))))
    return r2, mape


@dataclasses.dataclass
class PrefillPredictor:
    """Eq. 2: T_parprefill(L) = k_p * L + b_p."""
    k_p: float = 0.0
    b_p: float = 0.0
    r2: float = float("nan")
    mape: float = float("nan")

    def fit(self, lengths: Sequence[float], times: Sequence[float]):
        """Least-squares fit of the coefficients; returns self."""
        x = np.asarray(lengths, float)
        y = np.asarray(times, float)
        a = np.stack([x, np.ones_like(x)], axis=1)
        (self.k_p, self.b_p), *_ = np.linalg.lstsq(a, y, rcond=None)
        self.r2, self.mape = _fit_stats(y, a @ np.array([self.k_p, self.b_p]))
        return self

    def predict(self, length):
        """Predicted time for the given lengths."""
        return self.k_p * np.asarray(length, float) + self.b_p


@dataclasses.dataclass
class ChunkedIterPredictor:
    """Eq. 3: t_chunked = k_ctxp * L(P2 ctx) + k_ctxd * sum L(decode ctx) + b_c.

    The number of prefill tokens per iteration is absorbed into b_c (paper:
    "approximately equal to the maximum number of batched tokens")."""
    k_ctxp: float = 0.0
    k_ctxd: float = 0.0
    b_c: float = 0.0
    r2: float = float("nan")
    mape: float = float("nan")

    def fit(self, prefill_ctx: Sequence[float], decode_ctx_sum: Sequence[float],
            times: Sequence[float]):
        """Least-squares fit of the coefficients; returns self."""
        x1 = np.asarray(prefill_ctx, float)
        x2 = np.asarray(decode_ctx_sum, float)
        y = np.asarray(times, float)
        a = np.stack([x1, x2, np.ones_like(x1)], axis=1)
        coef, *_ = np.linalg.lstsq(a, y, rcond=None)
        self.k_ctxp, self.k_ctxd, self.b_c = map(float, coef)
        self.r2, self.mape = _fit_stats(y, a @ coef)
        return self

    def predict(self, prefill_ctx, decode_ctx_sum):
        """Predicted time for the given lengths."""
        return (self.k_ctxp * np.asarray(prefill_ctx, float)
                + self.k_ctxd * np.asarray(decode_ctx_sum, float) + self.b_c)


def profile_prefill(device_model, lengths=None) -> PrefillPredictor:
    """Profile partial-prefill times on a device model and fit Eq. 2."""
    lengths = lengths if lengths is not None else np.linspace(64, 8192, 40)
    times = [device_model.prefill_time(int(n)) for n in lengths]
    return PrefillPredictor().fit(lengths, times)


def profile_chunked(device_model, chunk_size: int = 512,
                    ctx_grid=None, dctx_grid=None) -> ChunkedIterPredictor:
    """Profile chunked-prefill iteration times and fit Eq. 3 (paper Fig. 3)."""
    ctx_grid = ctx_grid if ctx_grid is not None else np.linspace(0, 16384, 24)
    dctx_grid = dctx_grid if dctx_grid is not None else np.linspace(0, 65536, 12)
    xs1, xs2, ys = [], [], []
    for ctx in ctx_grid:
        for dctx in dctx_grid:
            n_d = max(int(dctx / 1200), 0)       # plausible decode batch size
            xs1.append(ctx)
            xs2.append(dctx)
            ys.append(device_model.chunked_iter_time(
                max(chunk_size - n_d, 1), int(ctx), dctx, n_d))
    return ChunkedIterPredictor().fit(xs1, xs2, ys)


def profile_prefill_measured(fn, lengths) -> PrefillPredictor:
    """Fit Eq. 2 on measured wall times: fn(length)->seconds."""
    times = [fn(int(n)) for n in lengths]
    return PrefillPredictor().fit(list(lengths), times)
