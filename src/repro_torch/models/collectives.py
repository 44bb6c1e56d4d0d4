"""Differentiable collectives over a process group, for the expert-parallel
MoE dispatch (``models/moe.py``) and the SSM core split by heads
(``models/ssm.py``).

Each rank runs the model on its own block of tokens in local view; these
are the conjugate pairs that make the backward pass of that program the
gradient of the global one:

* :func:`copy_to_group`: forward identity, backward all-reduce (sum). A
  tensor replicated over the group (the tokens of a data block, held by
  every rank of its expert group) gathers the gradient each rank's local
  work gives it.
* :func:`reduce_from_group`: forward all-reduce (sum), backward identity.
  The partial outputs of the group's ranks become the whole output, which
  every rank then holds and differentiates in full.
* :func:`gather_blocks`: the row blocks of a data group, of any sizes, as
  the whole ``[T, ...]`` on every rank (an all-reduce of a zero-filled
  buffer, at offsets from the block sizes that :func:`block_sizes`
  all-reduces); backward all-reduces the gradient and keeps this rank's
  rows.
* :func:`exchange_columns`: the columns (last dimension) a rank needs and
  does not hold, from the ranks that hold them, by one all-to-all over
  the group, in the order of an :func:`exchange_plan`; backward moves
  each gradient back by the reverse all-to-all and sums, at its holder,
  those of a column that went to several ranks. :func:`ssm_columns`
  gives the plans of the SSM block split by heads (``models/ssm.py``).

A plain ``dist.all_reduce`` has no gradient, and
``torch.distributed.nn.functional.all_reduce`` sums the gradient again on
the way back, which counts a replicated output once per rank.

``group=None`` stands for a group of this rank alone: every function but
:func:`exchange_columns`, which always has a group, is then the
identity. The collectives run over gloo, on CPU tensors and on
CUDA tensors (gloo stages them through the host), in the tensor's own
dtype, as JAX's ``psum`` does: the bf16 sum of two bf16 values is their
exact sum rounded once.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, in a new tensor."""
    buf = x.clone()
    dist.all_reduce(buf, group=group)
    return buf


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, start, total):
        ctx.group, ctx.start, ctx.n = group, start, x.shape[0]
        buf = x.new_zeros((total,) + tuple(x.shape[1:]))
        buf[start:start + x.shape[0]] = x
        return _all_reduce(buf, group)

    @staticmethod
    def backward(ctx, grad):
        grad = _all_reduce(grad, ctx.group)
        return grad[ctx.start:ctx.start + ctx.n], None, None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group``."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its gradient passed through."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def block_sizes(n: int, group) -> List[int]:
    """The first-dimension size of every rank's block of ``group``, in
    group-rank order (one all-reduce of a small int64 vector)."""
    if group is None:
        return [n]
    sizes = torch.zeros(dist.get_world_size(group), dtype=torch.int64)
    sizes[dist.get_rank(group)] = n
    dist.all_reduce(sizes, group=group)
    return sizes.tolist()


def gather_blocks(x: torch.Tensor, group,
                  sizes: Sequence[int]) -> torch.Tensor:
    """The row blocks of ``group`` stacked in group-rank order: ``[sum
    (sizes), ...]`` on every rank; ``sizes`` from :func:`block_sizes`.
    An integer ``x`` is gathered exactly (the buffer's other rows are
    0)."""
    if group is None:
        return x
    me = dist.get_rank(group)
    if sizes[me] != x.shape[0]:
        raise ValueError(f"block of {x.shape[0]} rows, sizes say "
                         f"{sizes[me]}")
    return _GatherBlocks.apply(x, group, sum(sizes[:me]), sum(sizes))


def column_blocks(width: int, m: int) -> List[List[int]]:
    """The columns of each of ``m`` ranks when ``width`` columns are split
    into ``m`` even contiguous blocks (as ``Shard`` lays them out)."""
    if width % m:
        raise ValueError(f"{width} columns do not split into {m} blocks")
    w = width // m
    return [list(range(r * w, (r + 1) * w)) for r in range(m)]


def exchange_plan(held: Sequence[Sequence[int]],
                  need: Sequence[Sequence[int]]) -> List[List[List[int]]]:
    """``plan[s][d]``: the columns rank ``s`` sends rank ``d``, in ``d``'s
    order of ``need[d]``: those ``d`` needs and does not hold, each from
    the lowest rank that holds it (``held[s]``: the columns rank ``s``
    holds). ``plan[d][d]`` is empty: a rank keeps what it holds."""
    m = len(held)
    owner = {}
    for s in reversed(range(m)):
        owner.update(dict.fromkeys(held[s], s))
    plan = [[[] for _ in range(m)] for _ in range(m)]
    for d in range(m):
        mine = set(held[d])
        for c in need[d]:
            if c in mine:
                continue
            if c not in owner:
                raise ValueError(f"rank {d} needs column {c}, which no "
                                 f"rank holds")
            plan[owner[c]][d].append(c)
    return plan


@functools.lru_cache(maxsize=None)
def ssm_columns(d_inner: int, n_heads: int, n_state: int, m: int
                ) -> Dict[str, Tuple[Tuple[Tuple[int, ...], ...], ...]]:
    """The SSM block's column layouts on a model axis of ``m`` ranks that
    split its heads evenly, each a tuple over the ranks of their columns:

    * ``"proj_blocks"``: the in-projection's output ``[z | x | B | C |
      dt]`` (``2·d_inner + 2·n_state + n_heads`` columns) in even blocks,
      as the column-parallel product leaves it;
    * ``"proj_heads"``: the columns a rank's heads read, in the order of a
      block of just those heads: their z and x channels, all of B and C
      (every head reads them) and their dt;
    * ``"conv_blocks"`` and ``"conv_heads"``: the same of the
      convolution's channels ``[x | B | C]``.

    ``exchange_plan(held, need)`` of a blocks/heads pair gives the
    columns each rank sends each other one."""
    if n_heads % m:
        raise ValueError(f"{n_heads} heads do not split over {m} ranks")
    hp, k = d_inner // n_heads, n_heads // m
    width = 2 * d_inner + 2 * n_state + n_heads
    proj, conv = [], []
    for r in range(m):
        lo, hi = r * k, (r + 1) * k
        x = list(range(lo * hp, hi * hp))
        bc = list(range(d_inner, d_inner + 2 * n_state))
        proj.append(tuple(x + [d_inner + c for c in x]
                          + [d_inner + c for c in bc]
                          + list(range(width - n_heads + lo,
                                       width - n_heads + hi))))
        conv.append(tuple(x + bc))
    return {"proj_blocks": tuple(map(tuple, column_blocks(width, m))),
            "proj_heads": tuple(proj),
            "conv_blocks": tuple(map(tuple, column_blocks(
                d_inner + 2 * n_state, m))),
            "conv_heads": tuple(conv)}


@functools.lru_cache(maxsize=None)
def _exchange_indices(held, need, rank: int):
    """The local positions of one rank's side of ``exchange_plan(held,
    need)``: what it sends (grouped by destination) and the split sizes,
    what it keeps, and where what it keeps and receives goes in its
    ``need`` order."""
    plan = exchange_plan(held, need)
    at = {c: i for i, c in enumerate(held[rank])}
    where = {c: i for i, c in enumerate(need[rank])}
    send = [at[c] for d in range(len(held)) for c in plan[rank][d]]
    recv = [c for s in range(len(held)) for c in plan[s][rank]]
    keep = [c for c in need[rank] if c in at]
    # the needed block is [kept; received] permuted by ``order``
    order = [0] * len(need[rank])
    for i, c in enumerate(keep + recv):
        order[where[c]] = i
    return (tuple(send), tuple(len(plan[rank][d]) for d in range(len(held))),
            tuple(len(plan[s][rank]) for s in range(len(held))),
            tuple(at[c] for c in keep), tuple(order))


class _ExchangeColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, send, send_splits, recv_splits, keep, order):
        def idx(v):
            return torch.tensor(v, dtype=torch.long, device=x.device)
        xt = x.movedim(-1, 0)
        ctx.group, ctx.width = group, xt.shape[0]
        ctx.splits = (list(send_splits), list(recv_splits))
        ctx.send, ctx.keep, ctx.order = idx(send), idx(keep), idx(order)
        recv = xt.new_empty((sum(recv_splits),) + tuple(xt.shape[1:]))
        dist.all_to_all_single(recv, xt.index_select(0, ctx.send),
                               list(recv_splits), list(send_splits),
                               group=group)
        out = torch.cat([xt.index_select(0, ctx.keep), recv])
        return out.index_select(0, ctx.order).movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        send_splits, recv_splits = ctx.splits
        gt = grad.movedim(-1, 0)
        # [kept; received]: the inverse of the forward's permutation
        g = torch.empty_like(gt).index_copy_(0, ctx.order, gt)
        n_keep = ctx.keep.shape[0]
        back = g.new_empty((sum(send_splits),) + tuple(g.shape[1:]))
        dist.all_to_all_single(back, g[n_keep:].contiguous(), send_splits,
                               recv_splits, group=ctx.group)
        gx = g.new_zeros((ctx.width,) + tuple(g.shape[1:]))
        gx.index_add_(0, ctx.send, back)
        gx.index_add_(0, ctx.keep, g[:n_keep])
        return (gx.movedim(0, -1).contiguous(),) + (None,) * 6


def exchange_columns(x: torch.Tensor, group, held, need,
                     rank: int) -> torch.Tensor:
    """``x [..., len(held[rank])]``, this rank's columns ``held[rank]``,
    as ``[..., len(need[rank])]``, the columns ``need[rank]`` in that
    order: those it lacks come from the ranks that hold them by one
    all-to-all over ``group`` (uneven splits, this rank's own empty), as
    :func:`exchange_plan` assigns them. ``held`` and ``need`` are tuples
    over the group's ranks (:func:`ssm_columns`)."""
    if x.shape[-1] != len(held[rank]):
        raise ValueError(f"{x.shape[-1]} columns, rank {rank} holds "
                         f"{len(held[rank])}")
    return _ExchangeColumns.apply(x, group,
                                  *_exchange_indices(held, need, rank))
