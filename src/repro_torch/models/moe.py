"""Mixture-of-Experts: top-k router, capacity drop rule, routed experts.

The counterpart of the JAX package's ``models/moe.py`` on one device: the
router (logits in the input's dtype, softmax in fp32, top-k renormalised),
the Switch load-balance loss, the routed SwiGLU experts and the shared
experts added on top.

Dispatch. The JAX package sorts the flat token-major ``(token, expert)``
pairs by expert with a stable sort, ranks each pair within its expert's
group, keeps it iff ``rank < capacity`` and scatters the kept rows into a
zero-filled ``[E, C, d]`` buffer for one batched product (``exact`` mode
sets ``C = T``, so nothing drops). Here the same sort and the same rule
pick the kept pairs, and each expert that received rows runs its SwiGLU on
exactly those rows: the buffer's zero rows add nothing to the output, and
at full width they would dominate it (kimi-k2's ``[384, 512, 7168]`` bf16
buffer of a 512-token chunk is 2.8 GB, 48x the routed FLOPs). Each
contribution is the expert's output times its gate weight rounded to the
input's dtype, as in the JAX package, but taken and summed per token in
fp32 and cast once (the JAX package rounds each product and the sum to
the input's dtype; the same values in fp32).

On the ``meta`` device (the dry-run's shape-only forward) nothing can be
routed: there are no values to sort or count. There the block runs the
JAX package's capacity mode shape for shape instead, the kept rows
scattered into an ``[E, C, d]`` buffer, three batched expert products
over it and the weighted rows gathered back, so the dry-run counts the
work of JAX's compiled step.

Expert parallelism. Under a process mesh installed by
:func:`repro_torch.models.sharding.set_rules` (a ``DeviceMesh``) the block
runs in local view, as the JAX package's ``shard_map`` body does: each
rank holds its data block of tokens (rows ``[i * t_loc, (i + 1) * t_loc)``
at data coordinate ``i``), the replicated router and shared experts, and
only its own routed experts (``[j * e_loc, (j + 1) * e_loc)`` at
expert-axis coordinate ``j``, cut by
:func:`repro_torch.models.sharding.shard_experts`). With an ``experts``
rule, outside ``exact`` mode, and tokens that split evenly over the batch
axis, each rank routes its block to its local experts (the pairs of other
ranks' experts sorted into a bucket of their own), keeps the pairs below
JAX's capacity at ``t_loc`` tokens and the global expert count, and the
partial outputs, cast to the input's dtype, are summed over the expert
axis. Otherwise the blocks are gathered over the data axis and the
global capacity rule runs on all the tokens, the GSPMD result. Either
way the shared experts are added after the sum, on every rank, and
``aux`` is the global value (router means and expert counts summed over
the data axis). ``DTensor`` tokens (the partitioned dry-run, or a
process mesh laid out by the dry-run's specs) run the same local-view
body on each card's blocks through ``local_map`` (:func:`ep_moe`), over
the process groups of the DTensors' mesh; on the ``meta`` device its
kept rows are the capacity buffers.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.collectives import (block_sizes, copy_to_group,
                                            gather_blocks, reduce_from_group)
from repro_torch.models.layers import mlp_shapes, swiglu
from repro_torch.models.sharding import (_axis_names, axis_group, get_mesh,
                                         get_rules, maybe_shard)

# leaves of the routed experts: [E, d, f] / [E, f, d] per layer
EXPERT_KEYS = frozenset(("w_gate", "w_up", "w_down"))


def moe_shapes(cfg, n_layers: int) -> Dict:
    """Shapes of ``n_layers`` stacked MoE blocks, as the JAX ``init_moe``
    lays them out: ``router [d, E]``, the routed ``w_gate``/``w_up [E, d,
    f]`` and ``w_down [E, f, d]``, and one SwiGLU dict ``shared_{i}`` per
    shared expert."""
    d, f, e, n = cfg.d_model, cfg.d_ff, cfg.n_experts, n_layers
    shapes = {"router": (n, d, e), "w_gate": (n, e, d, f),
              "w_up": (n, e, d, f), "w_down": (n, e, f, d)}
    for i in range(cfg.n_shared_experts):
        shapes[f"shared_{i}"] = mlp_shapes(d, f, n)
    return shapes


def capacity(t: int, cfg, exact: bool) -> int:
    """Rows an expert keeps out of ``t`` tokens (``exact``: all of them)."""
    if exact:
        return t
    c = int(t * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(min(t, c), min(t, 8))


def route(p: Dict, cfg, xt: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt [T, d] -> (probs [T, E] fp32, gate_w [T, k] renormalised,
    gate_idx [T, k])."""
    logits = (xt @ p["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, gate_idx


def dispatch(gate_idx: torch.Tensor, n_experts: int, cap: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX package's drop rule on ``gate_idx [T, k]``: the flat
    token-major pairs sorted by expert (stable), each kept iff its rank
    in its expert's group is below ``cap``. Returns, for the kept pairs in
    sorted order, their flat pair index (``token * k + j``) and the kept
    rows per expert ``[E]``, and the count of dropped pairs."""
    flat_e = gate_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(flat_e.numel(), device=flat_e.device) \
        - starts[flat_e[order]]
    keep = rank < cap
    return order[keep], counts.clamp(max=cap), (~keep).sum()


def moe_block(p: Dict, cfg, x: torch.Tensor, exact: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (out [B, S, d], aux scalar fp32)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = _tokens(x)
    probs, gate_w, gate_idx = route(p, cfg, xt)
    if isinstance(xt, DTensor):
        out, aux = ep_moe(p, cfg, xt, probs, gate_w, gate_idx, exact)
    elif x.device.type == "meta":
        out, aux = _capacity_block_meta(p, cfg, xt, probs, gate_w, gate_idx,
                                        capacity(t, cfg, exact))
        return out.reshape(b, s, d), aux
    elif get_mesh() is not None:
        out, aux = _moe_on_mesh(p, cfg, xt, probs, gate_w, gate_idx, exact)
    else:
        # load-balance auxiliary loss (Switch-style)
        ce = torch.bincount(gate_idx.reshape(-1), minlength=e).float() \
            / (t * k)
        aux = e * torch.sum(probs.mean(0) * ce)
        out = _local_experts(p, cfg, xt, gate_w, gate_idx, 0,
                             capacity(t, cfg, exact)).to(x.dtype)
    for i in range(cfg.n_shared_experts):
        sp = p[f"shared_{i}"]
        out = out + swiglu(xt, sp["w_gate"], sp["w_up"], sp["w_down"])
    if isinstance(out, DTensor):
        # back to [B, S, d]: rows split as the batch rows of ``x`` are
        out = out.redistribute(out.device_mesh, [
            Shard(0) if pl == Shard(0) else Replicate()
            for pl in x.placements])
    return out.reshape(b, s, d), aux


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """``x [B, S, d]`` as ``[B * S, d]``. A ``DTensor`` whose batch rows
    are whole or split is flattened on each card's block (``local_map``),
    so its gradient arrives laid out as ``x`` is: the dispatch hands back
    gradients split over all the tokens, which DTensor cannot unflatten
    into batch rows the mesh does not divide."""
    b, s, d = x.shape
    if not isinstance(x, DTensor) or any(
            p.is_partial() or p.is_shard() and p.dim != 0
            for p in x.placements):
        return x.reshape(b * s, d)
    pl = list(x.placements)
    return local_map(lambda a: a.reshape(-1, d), out_placements=pl,
                     in_placements=(tuple(pl),),
                     in_grad_placements=(tuple(pl),),
                     device_mesh=x.device_mesh)(x)


def _local_experts(p: Dict, cfg, xt: torch.Tensor, gate_w: torch.Tensor,
                   gate_idx: torch.Tensor, e0: int, cap: int
                   ) -> torch.Tensor:
    """The routed experts ``[e0, e0 + e_loc)`` that ``p``'s expert leaves
    hold (``e_loc`` of them) on ``xt [T, d]``: fp32 ``[T, d]``. When
    they are not all ``cfg.n_experts``, the pairs of other experts go to
    a last bucket ``e_loc`` of their own, so the stable sort ranks each
    local pair as the sort over all experts does; pairs ranked at or past
    ``cap`` drop. Each expert runs its SwiGLU on its kept rows, and the
    rows' outputs times their gate weights (rounded to ``xt``'s dtype)
    are summed per token."""
    t, d = xt.shape
    k = gate_idx.shape[1]
    e_loc = p["w_gate"].shape[0]
    if e_loc == cfg.n_experts:
        pairs, kept, _ = dispatch(gate_idx, e_loc, cap)
        kept = kept.tolist()
    else:
        le = gate_idx - e0
        le = torch.where((le >= 0) & (le < e_loc), le, e_loc)
        pairs, kept, _ = dispatch(le, e_loc + 1, cap)
        kept = kept[:e_loc].tolist()
        pairs = pairs[:sum(kept)]
    tok = pairs // k
    xs = xt[tok]                                  # kept rows, by expert
    ys, off = [], 0
    for ei, n in enumerate(kept):
        if n:
            ys.append(swiglu(xs[off:off + n], p["w_gate"][ei],
                             p["w_up"][ei], p["w_down"][ei]))
            off += n
    out = torch.zeros((t, d), dtype=torch.float32, device=xt.device)
    if ys:
        w = gate_w.reshape(-1)[pairs].to(xt.dtype).float()
        out.index_add_(0, tok, torch.cat(ys).float() * w[:, None])
    return out


def _ep_splits(cfg, t: int, n_b: int, m_ax, exact: bool) -> bool:
    """Whether ``t`` tokens over ``n_b`` data blocks take the
    expert-parallel dispatch (each block to its rank's experts at its own
    capacity); otherwise GSPMD's global capacity rule runs on all the
    tokens."""
    return m_ax is not None and not exact and t % n_b == 0 and t >= n_b


def _expert_axis(mesh, e: int):
    """The rules' experts axis on ``mesh``, or ``None`` where it does not
    divide the ``e`` experts (their leaves are then whole on every card,
    as ``sharding.divisible_spec`` leaves them)."""
    m_ax = (get_rules() or {}).get("experts")
    return m_ax if m_ax is not None and e % mesh[m_ax].size() == 0 \
        else None


def _expert_counts(gate_idx: torch.Tensor, e: int) -> torch.Tensor:
    """Pairs routed to each expert, ``[E]`` fp32 (exact below 2^24; a
    scatter-add, which the ``meta`` device runs where ``bincount``
    cannot)."""
    flat = gate_idx.reshape(-1).long()
    return torch.zeros(e, dtype=torch.float32, device=flat.device
                       ).scatter_add_(0, flat, torch.ones(
                           flat.shape, dtype=torch.float32,
                           device=flat.device))


def _moe_on_mesh(p: Dict, cfg, xt: torch.Tensor, probs: torch.Tensor,
                 gate_w: torch.Tensor, gate_idx: torch.Tensor, exact: bool,
                 mesh=None, sizes=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed half of the block on this rank's tokens ``xt [t_loc,
    d]`` in local view, over ``mesh`` (default: the installed process
    mesh): (out ``[t_loc, d]`` in ``xt``'s dtype, before the shared
    experts; the global aux). ``sizes``: every data block's rows
    (default: all-reduced from the ranks'; one block: every rank holds
    all the tokens). On the ``meta`` device the
    kept rows are the capacity buffers of :func:`_capacity_dispatch_meta`."""
    mesh = get_mesh() if mesh is None else mesh
    rules = get_rules() or {}
    e, k = cfg.n_experts, cfg.top_k
    data = axis_group(mesh, rules.get("batch"))
    m_ax = _expert_axis(mesh, e)
    experts = axis_group(mesh, m_ax)
    n_m = 1 if m_ax is None else mesh[m_ax].size()
    e_loc = e // n_m
    e0 = 0 if m_ax is None else mesh.get_local_rank(m_ax) * e_loc
    if p["w_gate"].shape[0] != e_loc:
        raise ValueError(f"this rank holds {p['w_gate'].shape[0]} routed "
                         f"experts, the mesh gives it {e_loc} of {e}: cut "
                         f"the params with sharding.shard_experts")
    if sizes is None:
        sizes = block_sizes(xt.shape[0], data)
    elif len(sizes) == 1:
        data = None     # every rank holds all the tokens
    t, n_b = sum(sizes), len(sizes)

    # the global load-balance loss: router means and expert counts
    # summed over the data axis (the counts carry no gradient)
    me = reduce_from_group(probs.sum(0), data) / t
    counts = reduce_from_group(_expert_counts(gate_idx, e), data)
    aux = e * torch.sum(me * (counts / (t * k)))

    def routed(xl, gw, gi, cap):
        if xl.device.type == "meta":
            return _capacity_dispatch_meta(xl, gw, gi, p["w_gate"],
                                           p["w_up"], p["w_down"], cap)
        return _local_experts(p, cfg, xl, gw, gi, e0, cap).to(xl.dtype)

    # the tokens of a data block are replicated over the expert axis:
    # their gradient (and the gate weights') sums over it
    xl, gw = copy_to_group(xt, experts), copy_to_group(gate_w, experts)
    if _ep_splits(cfg, t, n_b, m_ax, exact):
        if len(set(sizes)) != 1:
            raise ValueError(f"blocks of {sizes} rows: the expert-parallel "
                             f"dispatch takes the data axis's even blocks")
        part = routed(xl, gw, gate_idx, capacity(sizes[0], cfg, False))
        return reduce_from_group(part, experts), aux
    # GSPMD's dispatch: the global capacity rule over all t tokens
    start = sum(sizes[:0 if data is None else dist.get_rank(data)])
    part = routed(gather_blocks(xl, data, sizes),
                  gather_blocks(gw, data, sizes),
                  gather_blocks(gate_idx, data, sizes),
                  capacity(t, cfg, exact))
    out = reduce_from_group(part, experts)
    return out[start:start + xt.shape[0]], aux


def ep_moe(p: Dict, cfg, xt, probs, gate_w, gate_idx, exact: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_moe_on_mesh` on ``DTensor`` tokens ``xt [T, d]`` (with the
    router's ``probs``, gate weights and expert ids): each card runs it
    in local view on its blocks (``local_map``) over the process groups
    of the DTensors' mesh, as JAX's ``shard_map`` body: its block of
    tokens (split over the batch axis, whole over the expert axis) to its
    own experts, the partial outputs summed over the expert axis by one
    all-reduce. Returns ``(out [T, d]`` split as the dispatch splits the
    tokens, before the shared experts; ``aux)``."""
    mesh, rules = xt.device_mesh, get_rules() or {}
    names = list(mesh.mesh_dim_names)
    b_ax = _axis_names(rules.get("batch"))
    m_ax = _expert_axis(mesh, cfg.n_experts)
    rep = Replicate()
    n_b = math.prod(mesh.size(i) for i, a in enumerate(names) if a in b_ax)
    t = xt.shape[0]
    # the dispatch's even blocks of tokens; else all of them on every card
    split = _ep_splits(cfg, t, n_b, m_ax, exact)
    tok = [Shard(0) if split and a in b_ax else rep for a in names]
    sizes = [t // n_b] * n_b if split else [t]
    # each data block's tokens give part of its experts' gradient
    grad_w = [Partial() if split and a in b_ax else Shard(0) if a == m_ax
              else rep for a in names]
    exp = [Shard(0) if a == m_ax else rep for a in names]
    keys = ("w_gate", "w_up", "w_down")

    def body(xl, pl, gw, gi, *w):
        return _moe_on_mesh(dict(zip(keys, w)), cfg, xl, pl, gw, gi, exact,
                            mesh=mesh, sizes=sizes)
    args = [xt.redistribute(mesh, tok), probs.redistribute(mesh, tok),
            gate_w.redistribute(mesh, tok), gate_idx.redistribute(mesh, tok)
            ] + [p[w].redistribute(mesh, exp) for w in keys]
    return local_map(
        body, out_placements=(tok, [rep] * mesh.ndim),
        in_placements=(tuple(tok),) * 4 + (tuple(exp),) * 3,
        in_grad_placements=(tuple(tok),) * 4 + (tuple(grad_w),) * 3,
        device_mesh=mesh)(*args)


def _capacity_block_meta(p: Dict, cfg, xt: torch.Tensor,
                         probs: torch.Tensor, gate_w: torch.Tensor,
                         gate_idx: torch.Tensor, cap: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's capacity-mode dispatch, shapes only (meta
    tensors hold no values, so the slots are not those a sort would give):
    the ``T * k`` pairs scattered into a zero ``[E, C, d]`` buffer, the
    routed SwiGLU as three batched products over it, the weighted rows
    gathered back and summed per token, then the shared experts."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    flat_e = gate_idx.reshape(-1)
    ce = torch.zeros(e, dtype=torch.float32, device=xt.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32)) / (t * k)
    aux = e * torch.sum(probs.mean(0) * ce)
    out = _capacity_dispatch_meta(xt, gate_w, gate_idx, p["w_gate"],
                                  p["w_up"], p["w_down"], cap)
    for i in range(cfg.n_shared_experts):
        sp = p[f"shared_{i}"]
        out = out + swiglu(xt, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out, aux


def _capacity_dispatch_meta(xt, gate_w, gate_idx, w_gate, w_up, w_down,
                            cap: int) -> torch.Tensor:
    """The routed half of :func:`_capacity_block_meta` over the experts
    that ``w_gate`` holds: ``[T, d]`` in ``xt``'s dtype."""
    t, d = xt.shape
    e, k = w_gate.shape[0], gate_idx.shape[1]
    flat_e = gate_idx.reshape(-1).clamp(max=e - 1)
    tok = torch.arange(t * k, device=xt.device) // k
    slot = flat_e * cap + tok % cap
    buf = torch.zeros((e * cap, d), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, slot, xt.index_select(0, tok))
    buf = maybe_shard(buf.view(e, cap, d), "experts", None, None)
    y = swiglu(buf, w_gate, w_up, w_down)
    y = maybe_shard(y, "experts", None, None)
    contrib = y.reshape(e * cap, d).index_select(0, slot) \
        * gate_w.reshape(-1, 1).to(xt.dtype)
    out = torch.zeros((t, d), dtype=xt.dtype, device=xt.device)
    out.index_add_(0, tok, contrib)
    return out


def dense_expert_outputs(p: Dict, cfg, xt: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every routed expert on every token: ``y [E, T, d]`` in ``xt``'s
    dtype, and the gate weights ``w [T, E]`` (fp32; zero off the top-k)."""
    _, gate_w, gate_idx = route(p, cfg, xt)
    w = torch.zeros((xt.shape[0], cfg.n_experts), dtype=torch.float32,
                    device=xt.device).scatter_(1, gate_idx, gate_w)
    wg, wu = p["w_gate"].to(xt.dtype), p["w_up"].to(xt.dtype)
    h = torch.nn.functional.silu(xt @ wg) * (xt @ wu)     # [E, T, f]
    return h @ p["w_down"].to(xt.dtype), w


def moe_block_dense_ref(p: Dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Oracle: every expert on every token, combined by the gate weights
    (zero off the top-k); no capacity. O(T * E * d * f)."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    y, w = dense_expert_outputs(p, cfg, xt)
    out = torch.einsum("etd,te->td", y, w.to(xt.dtype))
    for i in range(cfg.n_shared_experts):
        sp = p[f"shared_{i}"]
        out = out + swiglu(xt, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out.reshape(b, s, d)
