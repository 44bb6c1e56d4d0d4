"""AdamW with a global-norm clip and a cosine schedule with linear warmup.

The counterpart of the JAX package's ``training/optimizer.py``, with its
arithmetic kept: the gradient is clipped to ``grad_clip`` by its global
norm (``+1e-9``), the moments are fp32 and bias-corrected by the step
count after its increment, and the update is ``delta = m̂ / (√v̂ + eps) +
weight_decay · p`` taken in fp32, ``p ← (p − lr · delta)`` cast back to
the parameter's dtype. ``torch.optim.AdamW`` orders the decay otherwise
and clips nothing, so the update is written out over the leaves; it is
functional: the inputs are left as they are and new trees are returned.
On ``DTensor`` leaves (the partitioned dry-run) each gradient is laid out
as its parameter once, and the global norm is one reduction over the
mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial

from repro_torch.training.tree import flatten, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """AdamW's hyperparameters and the learning-rate schedule's length
    (the JAX package's defaults)."""
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor): linear warmup
    over ``warmup_steps``, then a cosine decay to 0 at ``total_steps``;
    fp32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def init_adamw(params: Dict) -> Dict:
    """``{'step': 0 (int32), 'm': zeros, 'v': zeros}``, the moments fp32
    and on the parameters' device."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    device = next(iter(flatten(params).values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def _global_norm(tree: Dict) -> torch.Tensor:
    """The global L2 norm of the leaves. Over ``DTensor`` leaves each
    leaf's sum of squares is a partial sum over the whole mesh, and the
    sum of them all is reduced once, as one cross-shard reduction."""
    total = 0
    for leaf in flatten(tree).values():
        if isinstance(leaf, DTensor):
            mesh = leaf.device_mesh
            # this rank's share: its block's squares over the number of
            # ranks that hold the same block
            copies = math.prod(mesh.size(i) for i, p in
                               enumerate(leaf.placements) if not p.is_shard())
            sq = DTensor.from_local(
                torch.sum(torch.square(leaf.to_local().float())) / copies,
                mesh, [Partial()] * mesh.ndim, run_check=False)
        else:
            sq = torch.sum(torch.square(leaf.float()))
        total = total + sq
    return torch.sqrt(total)


def _like(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` gradient laid out as its parameter (its partial sums
    reduced once, before every use); a plain one as it is."""
    if isinstance(grad, DTensor):
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Dict, grads: Dict, state: Dict
                 ) -> Tuple[Dict, Dict, Dict]:
    """One AdamW step. Returns ``(new_params, new_state, {'grad_norm',
    'lr'})``; the gradient's global norm is the one before the clip."""
    step = state["step"] + 1
    flat_p = flatten(params)
    grads = unflatten({k: _like(g, flat_p[k])
                       for k, g in flatten(grads).items()})
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = cosine_lr(cfg, step)
    bc1 = 1 - torch.pow(cfg.b1, step)
    bc2 = 1 - torch.pow(cfg.b2, step)

    flat_g, flat_m, flat_v = (flatten(t) for t in (grads, state["m"],
                                                    state["v"]))
    new_p, new_m, new_v = {}, {}, {}
    # the reference's expressions leaf by leaf, with at most two
    # leaf-sized temporaries alive at once (an embedding at full width is
    # gigabytes)
    for k, p in flat_p.items():
        g = flat_g[k].float() * scale
        m2 = (cfg.b1 * flat_m[k]).add_((1 - cfg.b1) * g)
        t = (1 - cfg.b2) * g
        t.mul_(g)
        del g
        v2 = (cfg.b2 * flat_v[k]).add_(t)
        del t
        mh = m2 / bc1
        vh = v2 / bc2
        mh.div_(vh.sqrt_().add_(cfg.eps))
        del vh
        p32 = p.float()
        mh.add_(cfg.weight_decay * p32)
        new_p[k] = (p32 - mh.mul_(lr)).to(p.dtype)
        new_m[k], new_v[k] = m2, v2
    return (unflatten(new_p),
            {"step": step, "m": unflatten(new_m), "v": unflatten(new_v)},
            {"grad_norm": gnorm, "lr": lr})
