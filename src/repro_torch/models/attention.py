"""Attention of a dense GQA layer over the slot ("unified") cache.

The counterpart of the JAX package's ``models/attention.py`` for the slot
executor's serving path: parameter shapes, the ring write into the cache,
the position mask, softmax attention (plain and blocked) and the whole
attention block. The paged executor's attention runs in
:mod:`repro_torch.kernels` instead. MLA and the encoder/cross attention
are still to be ported.

Unified cache semantics
-----------------------
A layer's KV cache is ``{'k': [B, S_kv, Kv, D], 'v': [B, S_kv, Kv, D]}``
plus a position buffer ``kv_pos [B, S_kv]`` (-1 = empty) shared by the
layers. New tokens go to ``idx = (cache_len + arange(S_q)) % S_kv``, so a
cache shorter than the sequence is a ring; masks are derived from stored
positions alone:

    valid(q_pos, kv_pos) = kv_pos >= 0 and kv_pos <= q_pos
                           and (window == 0 or kv_pos > q_pos - window)

The JAX package writes the cache by one of two modes that give the same
values ("select", a gather and ``where`` over the whole sequence axis that
GSPMD can keep sharded, and "scatter"), picked by an environment variable.
Here the cache is written in place by one indexed store, with the values
of the "select" mode: when a chunk is longer than the cache, only its first
``S_kv`` tokens land.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import rmsnorm
from repro_torch.models.rope import position_encode

NEG_INF = -1e30

# score-matrix size above which attention switches to the blocked path
# (keeps small shapes on the plain path the parity tests use)
BLOCKED_ATTN_THRESHOLD = 1 << 22


def attention_shapes(cfg, n_layers: int) -> Dict[str, Tuple[int, ...]]:
    """Shapes of ``n_layers`` stacked attention blocks: ``wq/wk/wv`` are
    ``[d, heads * head_dim]`` and ``wo`` is ``[H * head_dim, d]``, plus the
    per-head qk-norm deltas where the config has them."""
    if cfg.mla_kv_lora_rank:
        raise NotImplementedError("MLA attention is not ported yet")
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (n_layers, d, h * hd), "wk": (n_layers, d, kv * hd),
              "wv": (n_layers, d, kv * hd), "wo": (n_layers, h * hd, d)}
    if cfg.qk_norm:
        shapes["q_norm"] = (n_layers, hd)
        shapes["k_norm"] = (n_layers, hd)
    return shapes


# ---------------------------------------------------------------------------
# cache write
# ---------------------------------------------------------------------------

def write_indices(cache_len: torch.Tensor, s_q: int,
                  s_kv: int) -> torch.Tensor:
    """cache_len [B] int -> idx [B, s_q] (ring-modular, contiguous)."""
    ar = torch.arange(s_q, dtype=cache_len.dtype, device=cache_len.device)
    return (cache_len[:, None] + ar[None, :]) % s_kv


def scatter_tokens(buf: torch.Tensor, new: torch.Tensor, idx: torch.Tensor,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write ``new [b, S_q, ...]`` into ``buf [B, S_kv, ...]`` at ``idx
    [b, S_q]`` (contiguous mod ``S_kv``, from :func:`write_indices`), in
    place; returns ``buf``. Row ``i`` of ``new`` goes to cache row
    ``rows[i]`` (default: ``i``). Only the first ``S_kv`` tokens of a
    longer chunk are written, as the JAX package's "select" mode does."""
    n = min(new.shape[1], buf.shape[1])
    if rows is None:
        rows = torch.arange(new.shape[0], device=buf.device)
    buf[rows[:, None], idx[:, :n].long()] = new[:, :n].to(buf.dtype)
    return buf


# ---------------------------------------------------------------------------
# masking + softmax attention
# ---------------------------------------------------------------------------

def make_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, window,
              causal: bool = True) -> torch.Tensor:
    """q_pos [B,Sq], kv_pos [B,Skv], window (0 = full) ->
    [B,1,Sq,Skv] bool."""
    q = q_pos[:, :, None]
    k = kv_pos[:, None, :]
    valid = k >= 0
    if causal:
        valid = valid & (k <= q)
    if window > 0:
        valid = valid & (k > q - window)
    return valid[:, None, :, :]


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q [B,Sq,H,D]; k,v [B,Skv,Kv,D]; mask [B,1,Sq,Skv] -> [B,Sq,H,D].

    Scores are fp32 (the products of the inputs summed in fp32, as the
    JAX package's ``preferred_element_type``); the probabilities are cast
    to ``v``'s dtype before the second product, which again sums in fp32.
    Rows with no valid key average ``v`` uniformly, as in the JAX package
    (``NEG_INF`` is finite)."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, dh).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    scores = scores.masked_fill(~mask[:, :, None, :, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


def blocked_gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_pos: torch.Tensor, kv_pos: torch.Tensor, window,
                       scale: float, block_q: int = 512,
                       block_k: int = 1024) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: a loop over KV blocks with a
    running ``(m, l, acc)``, queries in blocks, so the ``Sq x Skv`` score
    matrix is never materialised. The same arithmetic as the JAX
    package's ``lax.scan`` version; same result as :func:`gqa_attend` with
    :func:`make_mask`, except that rows with no valid key are zeros.

    q [B,Sq,H,D]; k,v [B,Skv,Kv,D]; q_pos [B,Sq]; kv_pos [B,Skv].
    """
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    bq = min(block_q, sq)
    bk = min(block_k, skv)
    pad_q = (-sq) % bq
    pad_k = (-skv) % bk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad_q), value=-1)
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad_k), value=-1)
    nq, nk = (sq + pad_q) // bq, (skv + pad_k) // bk

    qb = q.reshape(b, nq, bq, kvh, g, dh).float()
    qp = q_pos.reshape(b, nq, bq)[:, :, None, None, :, None]  # [B,nq,1,1,bq,1]
    m = torch.full((b, nq, kvh, g, bq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    lse = torch.zeros((b, nq, kvh, g, bq), dtype=torch.float32,
                      device=q.device)
    acc = torch.zeros((b, nq, kvh, g, bq, dh), dtype=torch.float32,
                      device=q.device)
    for j in range(nk):
        sl = slice(j * bk, (j + 1) * bk)
        kblk, vblk = k[:, sl], v[:, sl]
        s = torch.einsum("bnqkgd,bskd->bnkgqs", qb, kblk.float()) * scale
        kp = kv_pos[:, sl][:, None, None, None, None, :]      # [B,1,1,1,1,bk]
        valid = (kp >= 0) & (kp <= qp) & (qp >= 0)
        if window > 0:
            valid = valid & (kp > qp - window)
        s = s.masked_fill(~valid, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        lse = lse * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bnkgqs,bskd->bnkgqd", p.to(vblk.dtype).float(), vblk.float())
        m = m_new
    safe = torch.where(lse == 0.0, 1.0, lse)
    out = acc / safe[..., None]                               # [B,nq,Kv,g,bq,D]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, nq * bq, h, dh)
    return out[:, :sq].to(q.dtype)


# ---------------------------------------------------------------------------
# GQA block with cache
# ---------------------------------------------------------------------------

def attention_block(p: Dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                    kv_pos: torch.Tensor, idx: torch.Tensor,
                    layer_cache: Dict, window,
                    rows: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict]:
    """Self-attention over the unified cache, written in place.

    x [b,Sq,d]; positions [b,Sq] (absolute, -1 = padding); kv_pos
    [b,S_kv] (post-write positions); idx [b,Sq] write slots; layer_cache
    {'k','v'} of ``[B, S_kv, Kv, D]`` whose rows ``rows`` (default: the
    first ``b``) the batch maps to; window: int (0 = full attention).
    Returns (out [b,Sq,d], layer_cache).
    """
    b, sq, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(b, sq, h, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, sq, kvh, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, sq, kvh, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = position_encode(q, positions, cfg)
    k = position_encode(k, positions, cfg)

    scatter_tokens(layer_cache["k"], k, idx, rows)
    scatter_tokens(layer_cache["v"], v, idx, rows)
    if rows is None:
        ck, cv = layer_cache["k"][:b], layer_cache["v"][:b]
    else:
        ck = layer_cache["k"].index_select(0, rows)
        cv = layer_cache["v"].index_select(0, rows)
    if sq * ck.shape[1] >= BLOCKED_ATTN_THRESHOLD and sq > 1:
        out = blocked_gqa_attend(q, ck, cv, positions, kv_pos, window,
                                 hd ** -0.5)
    else:
        mask = make_mask(positions, kv_pos, window)
        out = gqa_attend(q, ck, cv, mask, hd ** -0.5)
    out = out.reshape(b, sq, h * hd) @ p["wo"].to(x.dtype)
    return out, layer_cache
