"""Attention over the slot ("unified") cache: dense GQA and MLA.

The counterpart of the JAX package's ``models/attention.py`` for the slot
executor's serving path: parameter shapes, the ring write into the cache,
the position mask, softmax attention (plain and blocked), the GQA
attention block, DeepSeek-V2's MLA block over a latent cache, and the
encoder-decoder's bidirectional encoder attention and cross attention.
The paged executor's attention runs in :mod:`repro_torch.kernels`
instead.

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
    per-head qk-norm deltas where the config has them; MLA's layout where
    the config has a latent KV rank."""
    if cfg.mla_kv_lora_rank:
        return mla_shapes(cfg, n_layers)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (n_layers, d, h * hd), "wk": (n_layers, d, kv * hd),
              "wv": (n_layers, d, kv * hd), "wo": (n_layers, h * hd, d)}
    if cfg.qk_norm:
        shapes["q_norm"] = (n_layers, hd)
        shapes["k_norm"] = (n_layers, hd)
    return shapes


def mla_shapes(cfg, n_layers: int) -> Dict[str, Tuple[int, ...]]:
    """Shapes of ``n_layers`` stacked MLA blocks (the JAX ``_init_mla``):
    the KV down-projection ``w_dkv [d, r_kv]`` with its norm, the shared
    rope key ``w_kpe [d, hd_r]``, the up-projections ``w_uk [r_kv, H,
    hd_n]`` and ``w_uv [r_kv, H, hd_v]``, ``wo [H * hd_v, d]``, and the
    query either through a LoRA (``w_dq``, ``q_norm``, ``w_uq``) or
    straight (``wq [d, H, hd_n + hd_r]``)."""
    d, h, n = cfg.d_model, cfg.n_heads, n_layers
    r_kv, r_q = cfg.mla_kv_lora_rank, cfg.mla_q_lora_rank
    hd_n, hd_r = cfg.mla_nope_head_dim, cfg.mla_rope_head_dim
    hd_v = cfg.mla_v_head_dim
    shapes = {"w_dkv": (n, d, r_kv), "w_kpe": (n, d, hd_r),
              "kv_norm": (n, r_kv), "w_uk": (n, r_kv, h, hd_n),
              "w_uv": (n, r_kv, h, hd_v), "wo": (n, h * hd_v, d)}
    if r_q:
        shapes.update(w_dq=(n, d, r_q), q_norm=(n, r_q),
                      w_uq=(n, r_q, h, hd_n + hd_r))
    else:
        shapes["wq"] = (n, d, h, hd_n + hd_r)
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


def _cache_rows(layer_cache: Dict, keys, b: int,
                rows: Optional[torch.Tensor]):
    """The batch's rows of the cache leaves ``keys``."""
    if rows is None:
        return [layer_cache[k][:b] for k in keys]
    return [layer_cache[k].index_select(0, rows) for k in keys]


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
    ck, cv = _cache_rows(layer_cache, ("k", "v"), b, rows)
    if sq * ck.shape[1] >= BLOCKED_ATTN_THRESHOLD and sq > 1:
        out = blocked_gqa_attend(q, ck, cv, positions, kv_pos, window,
                                 hd ** -0.5)
    else:
        mask = make_mask(positions, kv_pos, window)
        out = gqa_attend(q, ck, cv, mask, hd ** -0.5)
    out = out.reshape(b, sq, h * hd) @ p["wo"].to(x.dtype)
    return out, layer_cache


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V2): the cache holds the compressed latent and the
# rope key. The weight-absorbed form serves chunked prefill (partial KV
# present) and decode with one code path, as in the JAX package, which has
# no blocked variant of it.
# ---------------------------------------------------------------------------

def mla_attention_block(p: Dict, cfg, x: torch.Tensor,
                        positions: torch.Tensor, kv_pos: torch.Tensor,
                        idx: torch.Tensor, layer_cache: Dict, window,
                        rows: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Dict]:
    """Multi-head latent attention over the unified cache, written in
    place; arguments as :func:`attention_block`, with ``layer_cache``
    {'ckv': ``[B, S_kv, r_kv]``, 'kpe': ``[B, S_kv, hd_r]``}.

    ``W_uk`` is absorbed into the query, so scores are taken against the
    latent directly, and ``W_uv`` is applied after the weighted sum; both
    in fp32, scaled by ``(hd_n + hd_r) ** -0.5``. RoPE touches only the
    rope parts of the query and key.
    """
    b, sq, _ = x.shape
    h = cfg.n_heads
    hd_n, hd_r = cfg.mla_nope_head_dim, cfg.mla_rope_head_dim
    hd_v = cfg.mla_v_head_dim

    c_kv = rmsnorm(x @ p["w_dkv"].to(x.dtype), p["kv_norm"], cfg.norm_eps)
    k_pe = (x @ p["w_kpe"].to(x.dtype)).reshape(b, sq, 1, hd_r)
    k_pe = position_encode(k_pe, positions, cfg)[:, :, 0, :]

    if cfg.mla_q_lora_rank:
        q_lat = rmsnorm(x @ p["w_dq"].to(x.dtype), p["q_norm"],
                        cfg.norm_eps)
        q = torch.einsum("bsr,rhe->bshe", q_lat, p["w_uq"].to(x.dtype))
    else:
        q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(x.dtype))
    q_nope, q_pe = q[..., :hd_n], q[..., hd_n:]
    q_pe = position_encode(q_pe, positions, cfg)

    scatter_tokens(layer_cache["ckv"], c_kv, idx, rows)
    scatter_tokens(layer_cache["kpe"], k_pe, idx, rows)
    cckv, ckpe = (a.float() for a in _cache_rows(layer_cache,
                                                  ("ckv", "kpe"), b, rows))

    # absorb W_uk into q: scores over the latent directly
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope.float(),
                         p["w_uk"].float())
    scale = (hd_n + hd_r) ** -0.5
    scores = (torch.einsum("bshr,btr->bhst", q_abs, cckv)
              + torch.einsum("bshp,btp->bhst", q_pe.float(), ckpe)) * scale
    mask = make_mask(positions, kv_pos, window)           # [B,1,Sq,Skv]
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhst,btr->bshr", probs, cckv)
    out = torch.einsum("bshr,rhv->bshv", out_lat, p["w_uv"].float())
    out = out.reshape(b, sq, h * hd_v).to(x.dtype) @ p["wo"].to(x.dtype)
    return out, layer_cache


# ---------------------------------------------------------------------------
# encoder (bidirectional, no cache) and cross attention: the whisper
# backbone
# ---------------------------------------------------------------------------

def encoder_attention(p: Dict, cfg, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """Bidirectional self-attention over the whole input, no cache: x
    [B,S,d], positions [B,S] (for RoPE) -> [B,S,d]."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, h, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, s, kvh, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, s, kvh, hd)
    q = position_encode(q, positions, cfg)
    k = position_encode(k, positions, cfg)
    mask = torch.ones((b, 1, s, s), dtype=torch.bool, device=x.device)
    out = gqa_attend(q, k, v, mask, hd ** -0.5)
    return out.reshape(b, s, h * hd) @ p["wo"].to(x.dtype)


def cross_attention(p: Dict, cfg, x: torch.Tensor, k_enc: torch.Tensor,
                    v_enc: torch.Tensor) -> torch.Tensor:
    """x [B,Sq,d]; k_enc/v_enc [B,S_enc,Kv,D] (computed once at prefill)
    -> [B,Sq,d]. Every query sees every encoder position; no RoPE."""
    b, sq, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(b, sq, h, hd)
    mask = torch.ones((b, 1, sq, k_enc.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = gqa_attend(q, k_enc, v_enc, mask, hd ** -0.5)
    return out.reshape(b, sq, h * hd) @ p["wo"].to(x.dtype)


def cross_kv(p: Dict, cfg, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's cross-attention K and V ``[B,S_enc,Kv,D]`` from the
    encoder output ``[B,S_enc,d]``."""
    b, s, _ = enc_out.shape
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    k = (enc_out @ p["wk"].to(enc_out.dtype)).reshape(b, s, kvh, hd)
    v = (enc_out @ p["wv"].to(enc_out.dtype)).reshape(b, s, kvh, hd)
    return k, v
