"""Differentiable collectives over a process group, for the expert-parallel
MoE dispatch (``models/moe.py``).

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

A plain ``dist.all_reduce`` has no gradient, and
``torch.distributed.nn.functional.all_reduce`` sums the gradient again on
the way back, which counts a replicated output once per rank.

``group=None`` stands for a group of this rank alone: every function is
then the identity. The collectives run over gloo, on CPU tensors and on
CUDA tensors (gloo stages them through the host), in the tensor's own
dtype, as JAX's ``psum`` does: the bf16 sum of two bf16 values is their
exact sum rounded once.
"""
from __future__ import annotations

from typing import List, Sequence

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
