"""Mamba2 / SSD (state-space duality) blocks: chunked scan and recurrent
decode.

The counterpart of the JAX package's ``models/ssm.py``. The SSD chunked
algorithm (arXiv:2405.21060) splits the sequence into chunks of length Q:
the intra-chunk terms are attention-like products, the inter-chunk terms a
small recurrence over chunk states. The scan starts from a state ``h0``,
which is what a partially disaggregated prefill needs: the PPI ships its
SSM state (``[H, P, N]`` a layer) instead of a KV prefix, and the CPI's
chunked prefill resumes the scan from it.

The JAX package's inter-chunk ``lax.scan`` is a loop over the chunks
here, and the intra-chunk three-operand product takes ``C·B`` times the
decay matrix first, so no ``[B, nc, Q, Q, H, P]`` tensor is built. Casts
follow the JAX package: ``dt`` in fp32 through ``softplus``, the scan in
fp32, ``y`` back to the compute dtype, ``D`` cast to ``y``'s dtype and the
gated RMSNorm in fp32 with ``(1 + w)``.

Cache layout per layer: ``{'h': [B, H, P, N] fp32, 'conv': [B, W-1,
conv_dim]}`` in the model's dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.collectives import exchange_columns, ssm_columns
from repro_torch.models.layers import linear, rmsnorm
from repro_torch.models.sharding import _axis_names, get_rules


def ssm_dims(cfg) -> Tuple[int, int, int, int, int]:
    """``(d_inner, n_heads, head_dim P, state N, conv_dim)`` of a config;
    the convolution runs over (x, B, C) with one group."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = cfg.ssm_n_heads or max(1, d_inner // cfg.ssm_head_dim)
    p = d_inner // n_heads
    n = cfg.ssm_state
    conv_dim = d_inner + 2 * n
    return d_inner, n_heads, p, n, conv_dim


def ssm_shapes(cfg, n_layers: int) -> Dict[str, Tuple[int, ...]]:
    """Shapes of ``n_layers`` stacked SSM blocks (the JAX ``init_ssm``):
    ``in_proj [d, 2·d_inner + 2N + H]`` (z, x, B, C, dt), the depthwise
    ``conv_w [W, conv_dim]`` and ``conv_b``, ``A_log``, ``D`` and
    ``dt_bias`` per head, the gated norm over ``d_inner`` and
    ``out_proj [d_inner, d]``."""
    d, n = cfg.d_model, n_layers
    d_inner, h, _, ns, conv_dim = ssm_dims(cfg)
    return {"in_proj": (n, d, 2 * d_inner + 2 * ns + h),
            "conv_w": (n, cfg.ssm_conv_width, conv_dim),
            "conv_b": (n, conv_dim), "A_log": (n, h), "D": (n, h),
            "dt_bias": (n, h), "gate_norm": (n, d_inner),
            "out_proj": (n, d_inner, d)}


# the JAX ``init_ssm``'s fixed leaves as functions of their last width
# (fp32); ``conv_w`` is drawn at scale 0.3
SSM_FIXED_INIT = {
    "A_log": lambda h: torch.log(torch.linspace(1.0, 16.0, h)),
    "D": lambda h: torch.ones(h),
    "dt_bias": lambda h: torch.full((h,), math.log(math.expm1(0.01))),
    "conv_b": lambda c: torch.zeros(c),
}
SSM_INIT_SCALE = {"conv_w": 0.3}
# they stay fp32 whatever the model dtype (as the gated norm's weight
# does): in bf16, log(linspace(1, 16)) and log(expm1(0.01)) ~ -4.60
# would change value, and every dt with them
FP32_SSM_KEYS = frozenset(SSM_FIXED_INIT)


# ---------------------------------------------------------------------------
# SSD chunked scan
# ---------------------------------------------------------------------------

def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_neg: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor, h0: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P]; dt [B,S,H] (>0); a_neg [H] (<0); b_in, c_in [B,S,N];
    h0 [B,H,P,N]. Returns (y [B,S,H,P] in x's dtype, h_final [B,H,P,N]
    fp32). Tokens past ``S`` pad the last chunk with zeros (dt = 0: no
    decay, no update)."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    nc = (s + pad) // q
    xc = x.reshape(bsz, nc, q, h, p).float()
    dtc = dt.reshape(bsz, nc, q, h).float()
    bc = b_in.reshape(bsz, nc, q, n).float()
    cc = c_in.reshape(bsz, nc, q, n).float()

    a_cum = torch.cumsum(dtc * a_neg, dim=2)              # [B,nc,Q,H]
    xdt = xc * dtc[..., None]                             # [B,nc,Q,H,P]

    # intra-chunk (the "duality" products): (C·B) ⊙ L first, [B,nc,Q,K,H]
    l_mat = torch.exp(a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :])
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    l_mat = torch.where(causal[None, None, :, :, None], l_mat, 0.0)
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", cb[..., None] * l_mat, xdt)

    # chunk states
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # [B,nc,Q,H]
    states = torch.einsum("bckn,bckhp->bchpn", bc,
                          xdt * decay_to_end[..., None])

    # inter-chunk recurrence
    a_sum = torch.exp(a_cum[:, :, -1, :])                  # [B,nc,H]
    hprev = h0.float()
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hprev)
        hprev = hprev * a_sum[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                  # [B,nc,H,P,N]

    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cc, h_prevs) \
        * torch.exp(a_cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, nc * q, h, p)[:, :s]
    return y.to(x.dtype), hprev


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a_neg: torch.Tensor,
            b_in: torch.Tensor, c_in: torch.Tensor, h0: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token recurrent oracle for :func:`ssd_chunked`."""
    hcur = h0.float()
    ys = []
    for t in range(x.shape[1]):
        y, hcur = _recurrent_step(x[:, t], dt[:, t], a_neg, b_in[:, t],
                                  c_in[:, t], hcur)
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), hcur


def _recurrent_step(xt, dtt, a_neg, bt, ct, hprev):
    """One token of the recurrence in fp32: xt [B,H,P], dtt [B,H], bt, ct
    [B,N], hprev [B,H,P,N] -> (y [B,H,P], h [B,H,P,N])."""
    dtt = dtt.float()
    decay = torch.exp(dtt * a_neg)                         # [B,H]
    upd = torch.einsum("bh,bn,bhp->bhpn", dtt, bt.float(), xt.float())
    hnew = hprev.float() * decay[:, :, None, None] + upd
    return torch.einsum("bn,bhpn->bhp", ct.float(), hnew), hnew


# ---------------------------------------------------------------------------
# full mamba2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def _split_proj(zxbcdt: torch.Tensor, d_inner: int, n: int):
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, conv_cache: torch.Tensor,
                 w: torch.Tensor, bias: torch.Tensor,
                 token_mask: Optional[torch.Tensor] = None):
    """xbc [B,S,C]; conv_cache [B,W-1,C] (carry-in). Returns (out,
    new_cache).

    ``token_mask`` [B,S]: when the chunk carries trailing padding, the new
    conv cache holds the last W-1 *valid* inputs, gathered per row at the
    valid count."""
    width = w.shape[0]
    s = xbc.shape[1]
    full = torch.cat([conv_cache.to(xbc.dtype), xbc], dim=1)
    # depthwise conv, valid over the padded buffer
    out = sum(full[:, i:i + s, :] * w[i].to(xbc.dtype) for i in range(width))
    out = F.silu(out + bias.to(xbc.dtype))
    if token_mask is None:
        new_cache = full[:, full.shape[1] - (width - 1):, :]
    else:
        n_valid = token_mask.sum(dim=1)                    # [B]
        idx = n_valid[:, None] + torch.arange(width - 1,
                                              device=xbc.device)[None, :]
        new_cache = torch.gather(
            full, 1, idx[:, :, None].expand(-1, -1, full.shape[2]))
    return out, new_cache.to(conv_cache.dtype)


def _ssm_core(p: Dict, cfg, zxbcdt, h0, conv, decode: bool, token_mask,
              norm_sum=None):
    """The block between its two products: the causal conv, the SSD scan
    (or the recurrent step) and the gated norm, on ``zxbcdt [B, S,
    in_proj]``; returns ``(y [B, S, d_inner], h_final, new conv)``.

    With ``norm_sum``, a card's share of the heads, those of ``h0 [B, H,
    P, N]``: ``zxbcdt``, ``conv`` and every leaf of ``p`` hold just the
    columns those heads read, laid out as in a block of ``H`` heads
    (their z, x and dt channels, all of B and C: ``ssm_columns``'
    ``proj_heads`` and ``conv_heads``), and ``y`` and the new conv state
    are theirs; the gated norm's sum of squares over all ``d_inner``
    channels is taken by ``norm_sum`` (the sum over the cards that hold
    the other heads)."""
    d_inner, _, hp, n, _ = ssm_dims(cfg)
    h = h0.shape[1]
    z, xbc, dt_raw = _split_proj(zxbcdt, h * hp, n)
    xbc, new_conv = _causal_conv(xbc, conv, p["conv_w"], p["conv_b"],
                                 token_mask=token_mask)
    x_ssm = xbc[..., :h * hp]
    b_in = xbc[..., h * hp:h * hp + n]
    c_in = xbc[..., h * hp + n:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # [B,S,H]
    if token_mask is not None:
        dt = torch.where(token_mask[..., None], dt, 0.0)
    a_neg = -torch.exp(p["A_log"].float())                   # [H]

    bsz, s, _ = zxbcdt.shape
    xh = x_ssm.reshape(bsz, s, h, hp)
    if decode and s == 1:
        y, h_final = _recurrent_step(xh[:, 0], dt[:, 0], a_neg, b_in[:, 0],
                                     c_in[:, 0], h0)
        y = y[:, None].to(xh.dtype)
    else:
        y, h_final = ssd_chunked(xh, dt, a_neg, b_in, c_in, h0,
                                 cfg.ssm_chunk)
    y = y + xh.float().to(y.dtype) \
        * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, h * hp) * F.silu(z)
    if norm_sum is None:
        return rmsnorm(y, p["gate_norm"], cfg.norm_eps), h_final, new_conv
    # rmsnorm over every card's channels: the mean square all-reduced
    g = y.float()
    var = norm_sum((g * g).sum(dim=-1, keepdim=True)) / d_inner
    g = g * torch.rsqrt(var + cfg.norm_eps)
    return ((g * (1.0 + p["gate_norm"].float())).to(y.dtype), h_final,
            new_conv)


# the leaves whose last dimension runs over the conv channels (sharded by
# their specs as the conv state is, and exchanged with it)
_CONV_LEAVES = ("conv_w", "conv_b")


def _ssm_core_partitioned(p: Dict, cfg, zxbcdt, h0, conv, decode: bool,
                          token_mask):
    """:func:`_ssm_core` on ``DTensor``s, on each card's blocks
    (``local_map``): its batch rows and, where the heads rule's mesh
    dimension divides the heads and splits the projection and the conv
    channels into even blocks, its heads, as GSPMD keeps them.

    Split by heads, each card starts from its column blocks of the
    projection (``Shard(2)``, the column-parallel product's) and of the
    conv state and weights (their specs' channel blocks), and one
    all-to-all over the heads' dimension for each brings the columns its
    heads read that it lacks (``collectives.exchange_columns``: their z,
    x and dt, all of B and C); nothing else moves. The new conv state
    goes back to the spec's blocks by the reverse move (B and C stay:
    every card computes them whole); the recurrent state stays split by
    heads; the gated norm's sum of squares is all-reduced over the
    heads' dimension, and ``y`` comes out split there, as the
    row-parallel ``out_proj`` takes it. Otherwise (hymba-1.5b's 50 heads
    on 16 cards) every card runs every head of its rows on the whole
    projection and conv state. A state given as ``DTensor``s (a cache)
    comes back laid out as it was given; a plain one (training's zero
    state, which the step drops) comes back as computed, so no
    collective lays it out."""
    mesh = zxbcdt.device_mesh
    d_inner, n_heads, hp, n, conv_dim = ssm_dims(cfg)
    rows = [Shard(0) if pl == Shard(0) else Replicate()
            for pl in zxbcdt.placements]
    names = list(mesh.mesh_dim_names)
    h_dims = [i for i in (names.index(a) for a in _axis_names(
        (get_rules() or {}).get("heads")))
        if rows[i] == Replicate() and mesh.size(i) > 1]
    if len(h_dims) != 1 or any(w % mesh.size(h_dims[0]) for w in (
            n_heads, zxbcdt.shape[2], conv_dim)):
        h_dims = []
    heads = [Shard(1) if i in h_dims else pl for i, pl in enumerate(rows)]
    chans = [Shard(2) if i in h_dims else pl for i, pl in enumerate(rows)]
    given = [t.placements if isinstance(t, DTensor) else None
             for t in (h0, conv)]
    h0, conv = _as_dtensor(h0, mesh), _as_dtensor(conv, mesh)
    args = [zxbcdt.redistribute(mesh, chans), h0.redistribute(mesh, heads),
            conv.redistribute(mesh, chans)]
    places = [chans, heads, chans]
    if token_mask is not None:
        token_mask = _as_dtensor(token_mask, mesh).redistribute(mesh, rows)
    # the conv leaves in their channel blocks, the rest whole; each
    # card's rows give part of every weight's gradient, and its heads
    # part of a whole one's (the exchange's backward sums the conv
    # leaves' and the projection's and conv state's at their owners)
    w_places, w_grads = {}, {}
    for k, v in p.items():
        pl = [Shard(v.ndim - 1) if k in _CONV_LEAVES and i in h_dims
              else Replicate() for i in range(mesh.ndim)]
        w_places[k] = tuple(pl)
        w_grads[k] = tuple(
            Partial() if rows[i].is_shard() or (
                i in h_dims and pl[i] == Replicate()) else pl[i]
            for i in range(mesh.ndim))
    weights = {k: _as_dtensor(v, mesh).redistribute(mesh, w_places[k])
               for k, v in p.items()}

    def core(zx, h, c, mask, *w):
        w = dict(zip(weights, w))
        if not h_dims:
            return _ssm_core(w, cfg, zx, h, c, decode, mask)
        group, m = mesh.get_group(h_dims[0]), mesh.size(h_dims[0])
        rank = mesh.get_local_rank(h_dims[0])
        cols = ssm_columns(d_inner, n_heads, n, m)

        def to_heads(t):
            return exchange_columns(t, group, cols["conv_blocks"],
                                    cols["conv_heads"], rank)
        lo, hi = rank * h.shape[1], (rank + 1) * h.shape[1]
        w.update({k: to_heads(w[k]) for k in _CONV_LEAVES},
                 gate_norm=w["gate_norm"][lo * hp:hi * hp],
                 **{k: w[k][lo:hi] for k in ("dt_bias", "A_log", "D")})
        y, h_new, c_new = _ssm_core(
            w, cfg, exchange_columns(zx, group, cols["proj_blocks"],
                                     cols["proj_heads"], rank),
            h, to_heads(c), decode, mask,
            norm_sum=lambda t: _SumOver.apply(t, mesh, h_dims[0]))
        return y, h_new, exchange_columns(c_new, group, cols["conv_heads"],
                                          cols["conv_blocks"], rank)
    y, h_new, c_new = local_map(
        core, out_placements=(chans, heads, chans),
        in_placements=tuple(map(tuple, places)) + (
            None if token_mask is None else tuple(rows),)
        + tuple(w_places.values()),
        in_grad_placements=tuple(map(tuple, places)) + (
            None if token_mask is None else tuple(rows),)
        + tuple(w_grads.values()),
        device_mesh=mesh)(*args, token_mask, *weights.values())
    return (y,) + tuple(t if pl is None else t.redistribute(mesh, pl)
                        for t, pl in zip((h_new, c_new), given))


class _SumOver(torch.autograd.Function):
    """The sum over one mesh dimension's ranks, each rank's gradient the
    sum of theirs (every rank's output feeds its own part of the
    loss)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        from torch.distributed import _functional_collectives as funcol
        ctx.group = (mesh, dim)
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", ctx.group))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(
            grad.contiguous(), "sum", ctx.group)), None, None


def _as_dtensor(t: torch.Tensor, mesh) -> torch.Tensor:
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def ssm_block(p: Dict, cfg, x: torch.Tensor, cache: Dict, *,
              decode: bool = False,
              token_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict]:
    """x [B,S,d]; cache {'h', 'conv'} (the batch's rows) -> (out
    [B,S,d], new state {'h', 'conv'}); the caller writes the state back.

    ``token_mask`` [B,S] bool: False tokens (padding) must not touch the
    recurrent state, so their dt is zeroed (decay 1, update 0). Unlike
    attention, SSM state has no positional mask. ``decode`` with one token
    takes the recurrent step."""
    zxbcdt = linear(x, p["in_proj"])
    small = {k: p[k] for k in ("conv_w", "conv_b", "dt_bias", "A_log", "D",
                               "gate_norm")}
    if isinstance(zxbcdt, DTensor):
        y, h_final, new_conv = _ssm_core_partitioned(
            small, cfg, zxbcdt, cache["h"], cache["conv"], decode,
            token_mask)
    else:
        y, h_final, new_conv = _ssm_core(small, cfg, zxbcdt, cache["h"],
                                         cache["conv"], decode, token_mask)
    out = linear(y, p["out_proj"])
    return out, {"h": h_final, "conv": new_conv}
