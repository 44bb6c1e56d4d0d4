"""Plain PyTorch versions of the two attention kernels.

Line for line the JAX package's ``kernels/ref.py``: gather, einsum, mask
with ``NEG_INF``, softmax in fp32. The CPU paths use them, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def chunked_prefill_attention_ref(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, q_pos: torch.Tensor,
                                  kv_pos: torch.Tensor, window: int = 0,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """Attention of a prefill chunk against a (partial) cache.

    q:      [B, C, H, D]   chunk queries
    k, v:   [B, S, Kv, D]  KV cache contents (chunk already written)
    q_pos:  [B, C] int32   absolute positions of chunk tokens
    kv_pos: [B, S] int32   absolute positions of cache slots (-1 = empty)
    window: sliding window (0 = full causal)
    scale:  softmax scale (default ``D ** -0.5``)
    -> [B, C, H, D]
    """
    b, c, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, c, kvh, g, d).float()
    scores = torch.einsum("bckgd,bskd->bckgs", qg, k.float()) * scale
    valid = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window > 0:
        valid &= kv_pos[:, None, :] > q_pos[:, :, None] - window
    scores = torch.where(valid[:, :, None, None, :], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype,
                                      device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bckgs,bskd->bckgd", probs, v.float())
    # a row with no valid key would average garbage uniformly; the kernels
    # (and the Pallas kernel's l == 0 case) give zeros there
    out = out * valid.any(-1)[:, :, None, None, None]
    return out.reshape(b, c, h, d).to(q.dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               context_lens: torch.Tensor) -> torch.Tensor:
    """Decode attention over a paged KV cache.

    q:            [B, H, D]
    k/v_pages:    [P, page, Kv, D]
    block_tables: [B, max_pages] int32 (page ids; padding entries arbitrary)
    context_lens: [B] int32
    -> [B, H, D]
    """
    b, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    g = h // kvh
    # gather per-request KV: [B, max_pages*page, Kv, D]
    bt = block_tables.long()
    kk = k_pages[bt].reshape(b, max_pages * page, kvh, d)
    vv = v_pages[bt].reshape(b, max_pages * page, kvh, d)
    pos = torch.arange(max_pages * page, device=q.device)[None, :]
    valid = pos < context_lens[:, None]
    qg = q.reshape(b, kvh, g, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, kk.float()) * d ** -0.5
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype,
                                      device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, vv.float())
    # context_lens == 0 (padded decode lanes): zeros, as the kernels give
    out = out * (context_lens > 0)[:, None, None, None]
    return out.reshape(b, h, d).to(q.dtype)
