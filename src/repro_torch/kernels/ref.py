"""Plain PyTorch versions of the two attention kernels.

Line for line the JAX package's ``kernels/ref.py``: gather, einsum, mask
with ``NEG_INF``, softmax in fp32. The CPU paths use them, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.

Below them, models of the CUDA kernels' algorithms, for the tests only
(nothing on the main path calls them): the decode kernel's split-K with
its merge, and the prefill kernel's tile-by-tile online softmax with its
skip rule and P taken in the working dtype as two terms.
"""
from __future__ import annotations

import math
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


# ---------------------------------------------------------------------------
# models of the CUDA kernels' algorithms (tests only)
# ---------------------------------------------------------------------------

def paged_decode_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     context_lens: torch.Tensor,
                                     split_tokens: int = 256
                                     ) -> torch.Tensor:
    """The decode kernel's split-K (flash decoding), in plain PyTorch.

    Same arguments and result as :func:`paged_decode_attention_ref`. The
    table's width ``max_pages * page`` is cut into ``ceil(width /
    split_tokens)`` splits of consecutive positions. Each split with
    context computes its partial ``(m, l, acc)`` per head in fp32 (``m``
    the max score, ``l`` the sum of ``exp(s - m)``, ``acc`` the unnormalised
    sum of ``exp(s - m) v``); a split at or past ``min(ctx, width)`` is
    empty, ``(NEG_INF, 0, 0)``. The merge then weighs each split by
    ``exp(m - max m)``, in split order, counts an empty split as nothing
    and gives zeros where the total ``l`` is 0 (``ctx == 0``).
    """
    b, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    g = h // kvh
    width = block_tables.shape[1] * page
    n_splits = max(1, math.ceil(width / split_tokens))
    scale = d ** -0.5
    k_rows = k_pages.reshape(-1, kvh, d)
    v_rows = v_pages.reshape(-1, kvh, d)
    out = torch.zeros(b, h, d, dtype=torch.float32, device=q.device)
    for bi in range(b):
        ctx = min(int(context_lens[bi]), width)
        qg = q[bi].float().reshape(kvh, g, d)
        parts = []                                   # (m, l, acc) per split
        for sp in range(n_splits):
            t0 = sp * split_tokens
            n = min(split_tokens, ctx - t0)
            if n <= 0:
                parts.append((torch.full((kvh, g), NEG_INF),
                              torch.zeros(kvh, g), torch.zeros(kvh, g, d)))
                continue
            pos = torch.arange(t0, t0 + n)
            rows = block_tables[bi, pos // page].long() * page + pos % page
            kk, vv = k_rows[rows].float(), v_rows[rows].float()
            s = torch.einsum("kgd,nkd->kgn", qg, kk) * scale
            m = s.max(-1).values
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgn,nkd->kgd", p, vv)))
        mm = torch.stack([m for m, _, _ in parts]).max(0).values
        acc = torch.zeros(kvh, g, d)
        ll = torch.zeros(kvh, g)
        for m, l, a in parts:                        # in split order
            f = torch.where(l > 0, torch.exp(m - mm), torch.zeros_like(m))
            acc = acc + f[..., None] * a
            ll = ll + f * l
        o = torch.where(ll[..., None] > 0,
                        acc / torch.where(ll > 0, ll, 1.0)[..., None],
                        torch.zeros_like(acc))
        out[bi] = o.reshape(h, d)
    return out.to(q.dtype)


def prefill_tile_live(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                      window: int = 0) -> bool:
    """The prefill kernel's skip rule for one (query tile, key tile).

    ``q_pos`` holds the positions of the tile's query rows and ``kv_pos``
    those of its keys, -1 for padding. False only when no pair of the two
    can be valid: the tile holds no key position >= 0, or its least key
    position is past the greatest query position, or (``window > 0``) its
    greatest key position is at or before the least query position less
    the window. Nothing assumes the positions are sorted.
    """
    qv = q_pos[q_pos >= 0]
    kv = kv_pos[kv_pos >= 0]
    if qv.numel() == 0 or kv.numel() == 0:
        return False
    if int(kv.min()) > int(qv.max()):
        return False
    return not (window > 0 and int(kv.max()) <= int(qv.min()) - window)


def chunked_prefill_attention_tiled_ref(q: torch.Tensor, k: torch.Tensor,
                                        v: torch.Tensor, q_pos: torch.Tensor,
                                        kv_pos: torch.Tensor, window: int = 0,
                                        scale: Optional[float] = None, *,
                                        rows: int = 128, keys: int = 64
                                        ) -> torch.Tensor:
    """The prefill kernel's algorithm, in plain PyTorch.

    Same arguments and result as :func:`chunked_prefill_attention_ref`.
    Each (b, kv head) is cut into query tiles of ``rows // G`` queries (a
    tile's rows are its queries times the G heads of the group) and key
    tiles of ``keys`` keys. A query tile whose rows are all padding gives
    zeros; a key tile that :func:`prefill_tile_live` rejects is skipped.
    The others run the online softmax in fp32 with p exactly 0 for an
    invalid pair, and P V takes P in the working dtype as the kernel's
    tensor-core product does: P rounded, plus the rounding of the rest.
    Zeros where ``l == 0``.
    """
    b, c, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    bq = max(1, rows // g)
    scale = d ** -0.5 if scale is None else scale
    out = torch.zeros(b, c, h, d, dtype=torch.float32, device=q.device)
    for bi in range(b):
        for kh in range(kvh):
            heads = slice(kh * g, (kh + 1) * g)
            for q0 in range(0, c, bq):
                qt = q[bi, q0:q0 + bq, heads].float().reshape(-1, d)
                qp = q_pos[bi, q0:q0 + bq].repeat_interleave(g)
                if not bool((qp >= 0).any()):
                    continue
                m = torch.full((qt.shape[0],), NEG_INF)
                l = torch.zeros(qt.shape[0])
                acc = torch.zeros(qt.shape[0], d)
                for k0 in range(0, s, keys):
                    kp = kv_pos[bi, k0:k0 + keys]
                    if not prefill_tile_live(qp, kp, window):
                        continue
                    sc = qt @ k[bi, k0:k0 + keys, kh].float().T * scale
                    valid = (kp[None] >= 0) & (kp[None] <= qp[:, None])
                    if window > 0:
                        valid &= kp[None] > qp[:, None] - window
                    m_new = torch.maximum(
                        m, torch.where(valid, sc, NEG_INF).max(-1).values)
                    p = torch.where(valid, torch.exp(sc - m_new[:, None]),
                                    torch.zeros_like(sc))
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    head = p.to(q.dtype).float()
                    tail = (p - head).to(q.dtype).float()
                    acc = acc * alpha[:, None] + \
                        (head + tail) @ v[bi, k0:k0 + keys, kh].float()
                    m = m_new
                o = acc / torch.where(l == 0, 1.0, l)[:, None]
                out[bi, q0:q0 + bq, heads] = o.reshape(-1, g, d)
    return out.to(q.dtype)
