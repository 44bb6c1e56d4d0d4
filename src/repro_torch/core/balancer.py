"""The Balancer (paper §4.3 + Appendix A, Algorithm 1).

Splits each incoming request's prefill between the PPI (low-end device) and
the CPI (high-end device) such that the *predicted* partial-prefill time on
the PPI equals the predicted total chunked-prefill time of the remainder on
the CPI — equal stage throughput <=> both devices saturated.

Implementation follows Algorithm 1 line by line:
  * if the CPI lacks free KV blocks for the whole prompt, the entire prompt
    is prefilled on the PPI (partial length = L_in);
  * otherwise 512 candidate split points are scored with Eq. 2 / Eq. 1+3 and
    the argmin of |T_parprefill - T_chunked| wins.

Note: Algorithm 1 as printed estimates the mean chunked context as
(L_in + L_last)/2; Eq. 1 (arithmetic-series sum of per-iteration context,
first context = L_p) implies (L_p + L_last)/2. We default to the printed
algorithm and expose ``eq1_mean`` to switch — the difference is small since
L_last is within one chunk of L_in.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.predictor import ChunkedIterPredictor, PrefillPredictor


@dataclasses.dataclass
class CPIStats:
    """Statistics pulled from the chunked prefill instance (step (1))."""
    n_decode: int            # number of decode requests resident in the CPI
    decode_ctx_sum: float    # sum of their context lengths (L_ctxd)
    free_kv_blocks: int      # N_free
    block_size: int          # N_size
    max_batched_tokens: int  # B


@dataclasses.dataclass
class Balancer:
    """Alg. 1: pick the partial prefill length L_p from the two predictors."""
    prefill_pred: PrefillPredictor
    chunked_pred: ChunkedIterPredictor
    n_candidates: int = 512
    eq1_mean: bool = False

    def partial_prefill_length(self, l_in: int, stats: CPIStats) -> int:
        """Algorithm 1: choose the partial prefill length for a request."""
        if l_in <= 1:
            return l_in
        # Not enough free KV blocks on the CPI -> prefill entirely on the PPI.
        if stats.free_kv_blocks < math.ceil(l_in / stats.block_size):
            return l_in

        n = self.n_candidates
        l_p = np.ceil(np.arange(1, n + 1) / n * l_in)          # candidates
        t_prefill = self.prefill_pred.predict(l_p)             # Eq. 2

        n_p = max(stats.max_batched_tokens - stats.n_decode, 1)  # prefill tokens/iter
        l_c = l_in - l_p                                        # remainder on CPI
        n_iter = np.ceil(l_c / n_p)
        l_last = l_p + np.floor(l_c / n_p) * n_p                # last-iter context
        first_ctx = l_p if self.eq1_mean else float(l_in)
        mean_ctx = (first_ctx + l_last) / 2.0
        t_chunked = n_iter * self.chunked_pred.predict(mean_ctx,
                                                       stats.decode_ctx_sum)
        idx = int(np.argmin(np.abs(t_prefill - t_chunked)))
        return int(l_p[idx])
