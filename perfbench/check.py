"""The comparison that decides ``correct``.

Once the window has closed, a sample of the requests the program finished,
drawn from the seed and always holding the one with the most served
tokens, is run through the plain reference of the configuration's model
family (its ``served_logits``, handed in) over its prompt and served
tokens. Each served token's gap is how far the reference's logit of that
token lies below the reference's best logit at the same position; the run
is correct when the widest gap over the sample is within the cell's limit.
The program picks greedily (the lowest id within its tie margin of the
best), so a sound run's gaps are that margin plus its rounding in bf16.

The control (``served_gap(..., control=True)``) reads the same positions
with the reference in fp8 put in the program's place: the gap of the token
that the lower precision puts first.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

SAMPLE_TOKENS = 256      # served tokens a sample holds at least
SAMPLE_MIN_REQUESTS = 4  # and requests
SAMPLE_MAX_REQUESTS = 12


def sample(finished: Sequence[Tuple[np.ndarray, List[int]]], seed: int
           ) -> List[int]:
    """Indices into ``finished`` (prompt, served tokens): the request with
    the most served tokens, then others in an order drawn from ``seed``
    until it holds ``SAMPLE_TOKENS`` served tokens and
    ``SAMPLE_MIN_REQUESTS`` requests, or ``SAMPLE_MAX_REQUESTS``
    requests."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: len(finished[i][1]))
    rng = np.random.default_rng([seed % 2 ** 63, 0x43484b])
    rest = [int(i) for i in rng.permutation(len(finished)) if i != longest]
    picked, served = [longest], len(finished[longest][1])
    for i in rest:
        if len(picked) >= SAMPLE_MAX_REQUESTS or (
                served >= SAMPLE_TOKENS
                and len(picked) >= SAMPLE_MIN_REQUESTS):
            break
        picked.append(i)
        served += len(finished[i][1])
    return picked


def _inputs(picked, device):
    seqs, starts, served = [], [], []
    for prompt, tokens in picked:
        full = np.concatenate([np.asarray(prompt, np.int64),
                               np.asarray(tokens[:-1], np.int64)])
        seqs.append(torch.from_numpy(full).to(device))
        starts.append(len(prompt))
        served.append(torch.as_tensor(tokens, dtype=torch.long,
                                      device=device))
    return seqs, starts, served


def _gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return logits.max(-1).values - logits.gather(-1, tokens[:, None])[:, 0]


def served_gap(served_logits: Callable, params: Dict, dims: Dict, picked,
               device, control: bool = False) -> Dict:
    """Widest gap of the served tokens of ``picked`` [(prompt, tokens)]
    under the reference ``served_logits`` (a family reference's), and the
    number of tokens read. With ``control``, also ``control_gap_max``: at
    the same positions, the reference's gap of the token that the fp8
    reference puts first."""
    seqs, starts, served = _inputs(picked, device)
    ref = served_logits(params, dims, seqs, starts)
    gaps = torch.cat([_gaps(r, t) for r, t in zip(ref, served)])
    out = {"gap_max": float(gaps.max()), "tokens": int(gaps.numel())}
    if control:
        low = served_logits(params, dims, seqs, starts, quant="fp8")
        out["control_gap_max"] = float(torch.cat(
            [_gaps(r, lo.argmax(-1)) for r, lo in zip(ref, low)]).max())
    return out
