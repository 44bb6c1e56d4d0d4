"""Operations and bytes that the work of a call needs, from its shapes.

The yardstick of the benchmark's roofline and utilisation readings. Each
count is of what the algorithm needs, not of what an implementation does:
every input byte read once, every output byte written once, and the
operations of the valid query-key pairs only, so a kernel's share reads the
same whatever implements it later.

Peaks are NVIDIA's data sheet figures for one H100 SXM (dense, no
sparsity): 989 TFLOP/s in bf16 and 3.35 TB/s of HBM.
"""
from __future__ import annotations

from typing import Iterable, Tuple

PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float) -> Tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    HBM bandwidth and operations over the bf16 peak, and which one."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS_BF16
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def causal_pairs(ctx: int, c: int) -> int:
    """Valid query-key pairs of a causal chunk of ``c`` queries after
    ``ctx`` cached tokens: query ``i`` sees ``ctx + i + 1`` keys."""
    return c * ctx + c * (c + 1) // 2


def prefill_attn(ctx: int, c: int, h: int, kvh: int, d: int,
                 elt: int = 2) -> Tuple[int, int]:
    """(bytes, operations) of one chunked-prefill attention call on one
    layer: q and out of the ``c`` chunk tokens, K and V of the ``ctx + c``
    valid positions, and their int32 positions; ``4·h·d`` operations a
    valid pair (QKᵀ and PV)."""
    s = ctx + c
    nbytes = 2 * c * h * d * elt + 2 * s * kvh * d * elt + 4 * (c + s)
    return nbytes, 4 * causal_pairs(ctx, c) * h * d


def decode_attn(ctx_lens: Iterable[int], h: int, kvh: int, d: int,
                page: int, elt: int = 2) -> Tuple[int, int]:
    """(bytes, operations) of one paged decode attention call on one
    layer: K and V of each lane's valid context, its q and out, its
    context length and the block-table entries that cover the context."""
    lens = [int(x) for x in ctx_lens]
    ctx = sum(lens)
    pages = sum(-(-x // page) for x in lens)
    nbytes = (2 * ctx * kvh * d * elt + 2 * len(lens) * h * d * elt
              + 4 * (len(lens) + pages))
    return nbytes, 4 * ctx * h * d


def layer_params(d: int, h: int, kvh: int, hd: int, d_ff: int) -> int:
    """Weights of one dense decoder layer's matrices (q, k, v, o and the
    SwiGLU gate, up and down)."""
    return d * h * hd + 2 * d * kvh * hd + h * hd * d + 3 * d * d_ff


def model_flops(n_layers: int, d: int, h: int, kvh: int, hd: int,
                d_ff: int, vocab: int, *, tokens: int, attn_pairs: int,
                head_rows: int) -> int:
    """Operations of a forward over ``tokens`` tokens: two a weight a
    token through the layers, ``4·h·hd`` a valid attention pair in every
    layer, and two a head weight for each row whose logits are taken."""
    per_token = 2 * n_layers * layer_params(d, h, kvh, hd, d_ff)
    return (tokens * per_token + n_layers * 4 * h * hd * attn_pairs
            + head_rows * 2 * d * vocab)
