"""Attention over the slot ("unified") cache: dense GQA and MLA.

The counterpart of the JAX package's ``models/attention.py`` for the slot
executor's serving path and training's cache-free path: parameter
shapes, the ring write into the cache, the position mask, softmax
attention (plain and blocked), the GQA attention block, DeepSeek-V2's
MLA block over a latent cache, and the encoder-decoder's bidirectional
encoder attention and cross attention.
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
``S_kv`` tokens land. A cache held as a ``DTensor`` (the partitioned
dry-run, a process mesh) is written by the "select" mode itself, which
is elementwise in the cache's sequence axis and so keeps a
sequence-sharded cache sharded, as it does under GSPMD.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import functools

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.layers import linear, rmsnorm
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


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """``[..., heads * D]`` -> ``[..., heads, D]``. A ``DTensor`` whose
    last dimension is split in blocks the heads do not divide is first
    gathered along it (GSPMD's move for a sharding the reshape cannot
    keep)."""
    if isinstance(t, DTensor):
        last = t.dim() - 1
        mesh = t.device_mesh
        pl = [Replicate() if p.is_shard(last) and heads % mesh.size(i)
              else p for i, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(mesh, pl)
    return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """``[..., heads, D]`` -> ``[..., heads * D]``. A ``DTensor`` is
    reshaped on each card's block (``local_map``, a split of ``D`` first
    gathered), so its gradient arrives laid out as the heads are: some
    DTensor releases refuse to split a gradient sharded along the merged
    dimension back into heads it does not divide."""
    if not isinstance(t, DTensor):
        return t.reshape(*t.shape[:-2], -1)
    mesh, last = t.device_mesh, t.dim() - 1
    pl = [Replicate() if p.is_shard(last) else p for p in t.placements]
    t = t.redistribute(mesh, pl)
    return local_map(lambda x: x.reshape(*x.shape[:-2], -1),
                     out_placements=pl, in_placements=(tuple(pl),),
                     in_grad_placements=(tuple(pl),), device_mesh=mesh)(t)


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
    if isinstance(buf, DTensor):
        if rows is not None or new.shape[0] != buf.shape[0]:
            raise ValueError("a DTensor cache is written whole-batch "
                             "(rows=None, every row)")
        buf.copy_(select_write(buf, new, idx))
        return buf
    n = min(new.shape[1], buf.shape[1])
    if rows is None:
        rows = torch.arange(new.shape[0], device=buf.device)
    buf[rows[:, None], idx[:, :n].long()] = new[:, :n].to(buf.dtype)
    return buf


def select_write(buf: torch.Tensor, new: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """The JAX package's "select" write, out of place: ``buf [B, S_kv,
    ...]`` with ``new [B, S_q, ...]`` at ``idx [B, S_q]`` (contiguous mod
    ``S_kv``), every slot taking the token that lands on it, or keeping
    its value (a compare and ``where`` for one token, a gather for a
    chunk)."""
    s_kv, c = buf.shape[1], new.shape[1]
    tail = (1,) * (new.dim() - 2)
    slots = torch.arange(s_kv, dtype=idx.dtype, device=buf.device)[None, :]
    new = new.to(buf.dtype)
    if c == 1:
        hit = (slots == idx).reshape(idx.shape[0], s_kv, *tail)
        return torch.where(hit, new, buf)
    j = (slots - idx[:, :1]) % s_kv                       # [B, S_kv]
    mask = (j < c).reshape(j.shape + tail)
    src = j.clamp(max=c - 1).long().reshape(j.shape + tail).expand(
        (-1, -1) + tuple(new.shape[2:]))
    return torch.where(mask, new.gather(1, src), buf)


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
    m, lse, acc = blocked_partials(q, k, v, q_pos, kv_pos, window, scale,
                                   block_q, block_k)
    return _blocked_out(q, lse, acc)


def blocked_partials(q, k, v, q_pos, kv_pos, window, scale: float,
                     block_q: int = 512, block_k: int = 1024):
    """The running ``(m, l, acc)`` of :func:`blocked_gqa_attend` after the
    last KV block, unnormalised: ``[B, nq, Kv, g, bq]`` twice and ``[B,
    nq, Kv, g, bq, D]``, fp32."""
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
    return m, lse, acc


def _blocked_out(q: torch.Tensor, lse: torch.Tensor,
                 acc: torch.Tensor) -> torch.Tensor:
    """``acc / l`` of :func:`blocked_partials` as ``[B, Sq, H, D]`` in
    ``q``'s dtype (rows with no valid key zero)."""
    b, sq, h, dh = q.shape
    nq, bq = acc.shape[1], acc.shape[4]
    safe = torch.where(lse == 0.0, 1.0, lse)
    out = acc / safe[..., None]                               # [B,nq,Kv,g,bq,D]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, nq * bq, h, dh)
    return out[:, :sq].to(q.dtype)


def _gqa_partials(q, k, v, mask, scale: float):
    """:func:`gqa_attend`'s scores unnormalised: ``(m, l, acc)`` of
    ``[B, Kv, g, Sq]`` twice and ``[B, Kv, g, Sq, D]``, fp32."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    scores = scores.masked_fill(~mask[:, :, None, :, :], NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    acc = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(),
                       v.float())
    return m, p.sum(dim=-1), acc


def _combine(m, lse, acc, mesh, dims):
    """The partial softmaxes of the ranks of ``mesh``'s dimensions
    ``dims`` (each over its own slice of the keys) merged: the global
    max, then the rescaled sums, all-reduced over each dimension in
    turn."""
    from torch.distributed import _functional_collectives as funcol
    m_all = m
    for i in dims:
        m_all = funcol.all_reduce(m_all, "max", (mesh, i))
    c = torch.exp(m - m_all)
    lse, acc = lse * c, acc * c[..., None]
    for i in dims:
        lse = funcol.all_reduce(lse, "sum", (mesh, i))
        acc = funcol.all_reduce(acc, "sum", (mesh, i))
    return lse, acc


def _layout(q: torch.Tensor, k: torch.Tensor):
    """How attention runs over one card's blocks, for ``DTensor`` queries
    ``q [B, Sq, H, ...]`` and keys ``k [B, S, Kv, ...]`` (or a latent
    ``[B, S, r]``, MLA's): per mesh dimension, the placements of (q, k,
    q positions, key positions), as GSPMD lays attention out. Rows of the
    batch stay split; query rows split by a "seq" rule stay split, the
    keys gathered; heads stay split where the keys' heads split the same
    way (the queries' group of each local key head is local); keys split
    along the sequence (a sequence-sharded cache) stay split, the queries
    gathered, and those dimensions are returned (``split``): each rank's
    partial softmax is combined over them. Returns ``(placements,
    split)``, the placements a tuple of four lists."""
    rep = Replicate()
    out = ([], [], [], [])
    split = []
    heads = k.dim() == 4
    for i, (a, c) in enumerate(zip(q.placements, k.placements)):
        n = k.device_mesh.size(i)
        if c.is_shard(0) or (a.is_shard(0) and not c.is_shard()):
            row = (Shard(0),) * 4
        elif c.is_shard(1) and a.is_shard(1):
            row = (Shard(1), rep, Shard(1), rep)
        elif c.is_shard(1):
            row = (rep, Shard(1), rep, Shard(1))
            split.append(i)
        elif heads and (c.is_shard(2) or (a.is_shard(2)
                                          and k.shape[2] % n == 0)):
            row = (Shard(2), Shard(2), rep, rep)
        elif a.is_shard(2) and not heads:
            row = (Shard(2), rep, rep, rep)
        elif a.is_shard(1):
            row = (Shard(1), rep, Shard(1), rep)
        else:
            row = (rep,) * 4
        for lst, pl in zip(out, row):
            lst.append(pl)
    return out, split


def _grad_placements(mine, other):
    """An input's gradient placements in a local attention region: a
    ``Partial`` sum on each mesh dimension where it is whole while the
    other operand is split (each rank's work gives part of it)."""
    return tuple(Partial() if p.is_replicate() and o.is_shard() else p
                 for p, o in zip(mine, other))


def _local_attention(fn, queries, keys, q_pos, kv_pos):
    """``fn(*queries, *keys, q_pos, kv_pos, split=, mesh=)`` on this
    card's blocks of ``DTensor`` operands laid out by :func:`_layout`
    (``queries`` laid out as the first, ``keys`` as theirs;
    ``q_pos``/``kv_pos`` may be ``None``), the smallest region that runs
    as local tensors (``local_map``): ``fn`` gets the mesh dimensions
    ``split`` that cut the keys and combines its partial softmaxes over
    them. Returns a ``DTensor`` laid out as the queries, whole over
    ``split``."""
    (qp, kp, qpp, kvp), split = _layout(queries[0], keys[0])
    mesh = queries[0].device_mesh
    args = [t.redistribute(mesh, qp) for t in queries] \
        + [t.redistribute(mesh, kp) for t in keys]
    places = [tuple(qp)] * len(queries) + [tuple(kp)] * len(keys)
    grads = [_grad_placements(qp, kp)] * len(queries) \
        + [_grad_placements(kp, qp)] * len(keys)
    for t, pl in ((q_pos, qpp), (kv_pos, kvp)):
        if t is None:
            args.append(None)
            places.append(None)
            grads.append(None)
        else:
            args.append(_replicated(t, mesh).redistribute(mesh, pl))
            places.append(tuple(pl))
            grads.append(tuple(pl))
    out_pl = [Replicate() if i in split else p for i, p in enumerate(qp)]

    def body(*local):
        # DTensor views the gradients that leave the region: contiguous
        local = [t if t is None or not t.is_floating_point()
                 else _ContiguousGrad.apply(t) for t in local]
        return fn(*local, split=split, mesh=mesh)
    return local_map(body, out_placements=out_pl,
                     in_placements=tuple(places),
                     in_grad_placements=tuple(grads),
                     device_mesh=mesh)(*args)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _replicated(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` as a ``DTensor`` on ``mesh``, whole on every rank if it is a
    plain tensor."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: Optional[torch.Tensor], kv_pos: Optional[torch.Tensor],
           window, scale: float, blocked: bool = False) -> torch.Tensor:
    """Softmax attention of ``q [B,Sq,H,D]`` over ``k, v [B,Skv,Kv,D]``
    under the position mask (:func:`make_mask`; ``q_pos=None``: every key
    valid), blocked (:func:`blocked_gqa_attend`) or not
    (:func:`gqa_attend`). ``DTensor`` operands run over this card's
    blocks (:func:`_local_attention`)."""
    if isinstance(q, DTensor):
        return _local_attention(
            functools.partial(_gqa_local, window=window, scale=scale,
                              blocked=blocked), [q], [k, v], q_pos, kv_pos)
    return _gqa_local(q, k, v, q_pos, kv_pos, window=window, scale=scale,
                      blocked=blocked)


def _gqa_local(q, k, v, q_pos, kv_pos, *, window, scale, blocked,
               split=(), mesh=None):
    """:func:`attend` on local tensors; the partial softmaxes combined
    over the mesh dimensions ``split`` that cut the keys."""
    if blocked:
        m, lse, acc = blocked_partials(q, k, v, q_pos, kv_pos, window,
                                       scale)
        if split:
            lse, acc = _combine(m, lse, acc, mesh, split)
        return _blocked_out(q, lse, acc)
    if q_pos is None:
        mask = torch.ones((q.shape[0], 1, q.shape[1], k.shape[1]),
                          dtype=torch.bool, device=q.device)
    else:
        mask = make_mask(q_pos, kv_pos, window)
    if not split:
        return gqa_attend(q, k, v, mask, scale)
    m, lse, acc = _gqa_partials(q, k, v, mask, scale)
    lse, acc = _combine(m, lse, acc, mesh, split)
    b, sq, h, dh = q.shape
    out = (acc / lse[..., None]).permute(0, 3, 1, 2, 4)
    return out.reshape(b, sq, h, dh).to(q.dtype)


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
                    kv_pos: torch.Tensor, idx: Optional[torch.Tensor],
                    layer_cache: Optional[Dict], window,
                    rows: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self-attention over the unified cache, written in place.

    x [b,Sq,d]; positions [b,Sq] (absolute, -1 = padding); kv_pos
    [b,S_kv] (post-write positions); idx [b,Sq] write slots; layer_cache
    {'k','v'} of ``[B, S_kv, Kv, D]`` whose rows ``rows`` (default: the
    first ``b``) the batch maps to; window: int (0 = full attention).
    ``layer_cache=None`` is the cache-free (training) path: the chunk
    attends over its own K/V (``kv_pos`` = its positions) and nothing is
    written. Returns (out [b,Sq,d], layer_cache).
    """
    b, sq, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(linear(x, p["wq"]), h)
    k = split_heads(linear(x, p["wk"]), kvh)
    v = split_heads(linear(x, p["wv"]), kvh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = position_encode(q, positions, cfg)
    k = position_encode(k, positions, cfg)

    if layer_cache is None:
        ck, cv = k, v
    else:
        scatter_tokens(layer_cache["k"], k, idx, rows)
        scatter_tokens(layer_cache["v"], v, idx, rows)
        ck, cv = _cache_rows(layer_cache, ("k", "v"), b, rows)
    blocked = sq * ck.shape[1] >= BLOCKED_ATTN_THRESHOLD and sq > 1
    out = attend(q, ck, cv, positions, kv_pos, window, hd ** -0.5, blocked)
    out = linear(merge_heads(out), p["wo"])
    return out, layer_cache


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V2): the cache holds the compressed latent and the
# rope key. The weight-absorbed form serves chunked prefill (partial KV
# present) and decode with one code path, as in the JAX package, which has
# no blocked variant of it.
# ---------------------------------------------------------------------------

def mla_attention_block(p: Dict, cfg, x: torch.Tensor,
                        positions: torch.Tensor, kv_pos: torch.Tensor,
                        idx: Optional[torch.Tensor],
                        layer_cache: Optional[Dict], window,
                        rows: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Multi-head latent attention over the unified cache, written in
    place; arguments as :func:`attention_block`, with ``layer_cache``
    {'ckv': ``[B, S_kv, r_kv]``, 'kpe': ``[B, S_kv, hd_r]``} (``None``:
    the chunk's own latent, nothing written).

    ``W_uk`` is absorbed into the query, so scores are taken against the
    latent directly, and ``W_uv`` is applied after the weighted sum; both
    in fp32, scaled by ``(hd_n + hd_r) ** -0.5``. RoPE touches only the
    rope parts of the query and key.
    """
    b, sq, _ = x.shape
    h = cfg.n_heads
    hd_n, hd_r = cfg.mla_nope_head_dim, cfg.mla_rope_head_dim
    hd_v = cfg.mla_v_head_dim

    c_kv = rmsnorm(linear(x, p["w_dkv"]), p["kv_norm"], cfg.norm_eps)
    k_pe = (linear(x, p["w_kpe"])).reshape(b, sq, 1, hd_r)
    k_pe = position_encode(k_pe, positions, cfg)[:, :, 0, :]

    if cfg.mla_q_lora_rank:
        q_lat = rmsnorm(linear(x, p["w_dq"]), p["q_norm"],
                        cfg.norm_eps)
        q = torch.einsum("bsr,rhe->bshe", q_lat, p["w_uq"].to(x.dtype))
    else:
        q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(x.dtype))
    q_nope, q_pe = q[..., :hd_n], q[..., hd_n:]
    q_pe = position_encode(q_pe, positions, cfg)

    if layer_cache is None:
        cckv, ckpe = c_kv.float(), k_pe.float()
    else:
        scatter_tokens(layer_cache["ckv"], c_kv, idx, rows)
        scatter_tokens(layer_cache["kpe"], k_pe, idx, rows)
        cckv, ckpe = (a.float() for a in _cache_rows(
            layer_cache, ("ckv", "kpe"), b, rows))

    # absorb W_uk into q: scores over the latent directly
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope.float(),
                         p["w_uk"].float())
    fn = functools.partial(_mla_local, window=window,
                           scale=(hd_n + hd_r) ** -0.5)
    if isinstance(q_abs, DTensor):
        out_lat = _local_attention(fn, [q_abs, q_pe.float()], [cckv, ckpe],
                                   positions, kv_pos)
    else:
        out_lat = fn(q_abs, q_pe.float(), cckv, ckpe, positions, kv_pos)
    out = torch.einsum("bshr,rhv->bshv", out_lat, p["w_uv"].float())
    out = linear(out.reshape(b, sq, h * hd_v).to(x.dtype), p["wo"])
    return out, layer_cache


def _mla_local(q_abs, q_pe, cckv, ckpe, q_pos, kv_pos, *, window, scale,
               split=(), mesh=None):
    """MLA's attention over the latent on local tensors: ``q_abs [B, Sq,
    H, r]`` and ``q_pe [B, Sq, H, p]`` against ``cckv [B, S, r]`` and
    ``ckpe [B, S, p]`` (fp32) -> ``out_lat [B, Sq, H, r]``; the partial
    softmaxes combined over the mesh dimensions ``split`` that cut the
    latent's sequence."""
    scores = (torch.einsum("bshr,btr->bhst", q_abs, cckv)
              + torch.einsum("bshp,btp->bhst", q_pe, ckpe)) * scale
    mask = make_mask(q_pos, kv_pos, window)               # [B,1,Sq,Skv]
    scores = scores.masked_fill(~mask, NEG_INF)
    if not split:
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhst,btr->bshr", probs, cckv)
    m = scores.amax(dim=-1)
    e = torch.exp(scores - m[..., None])
    lse, acc = _combine(m, e.sum(dim=-1),
                        torch.einsum("bhst,btr->bhsr", e, cckv), mesh, split)
    return (acc / lse[..., None]).permute(0, 2, 1, 3)


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
    q = split_heads(linear(x, p["wq"]), h)
    k = split_heads(linear(x, p["wk"]), kvh)
    v = split_heads(linear(x, p["wv"]), kvh)
    q = position_encode(q, positions, cfg)
    k = position_encode(k, positions, cfg)
    out = attend(q, k, v, None, None, 0, hd ** -0.5)
    return linear(merge_heads(out), p["wo"])


def cross_attention(p: Dict, cfg, x: torch.Tensor, k_enc: torch.Tensor,
                    v_enc: torch.Tensor) -> torch.Tensor:
    """x [B,Sq,d]; k_enc/v_enc [B,S_enc,Kv,D] (computed once at prefill)
    -> [B,Sq,d]. Every query sees every encoder position; no RoPE."""
    b, sq, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = split_heads(linear(x, p["wq"]), h)
    out = attend(q, k_enc, v_enc, None, None, 0, hd ** -0.5)
    return linear(merge_heads(out), p["wo"])


def cross_kv(p: Dict, cfg, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's cross-attention K and V ``[B,S_enc,Kv,D]`` from the
    encoder output ``[B,S_enc,d]``."""
    b, s, _ = enc_out.shape
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    k = split_heads(linear(enc_out, p["wk"]), kvh)
    v = split_heads(linear(enc_out, p["wv"]), kvh)
    return k, v
