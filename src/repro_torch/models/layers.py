"""Basic layers: the embedding lookup, RMSNorm, SwiGLU MLP, its shapes and
the truncated-normal init."""
from __future__ import annotations

from typing import Optional, Sequence

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map


def dense_init(shape: Sequence[int], *, generator: torch.Generator,
               scale: Optional[float] = None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times ``scale``
    (default ``fan_in ** -0.5``), drawn in fp32 and stored in ``dtype``.

    ``generator`` must live on ``device``. The draws differ from
    ``jax.random``'s for the same seed; parity tests bridge JAX weights
    over instead (:mod:`repro_torch.models.bridge`)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(std).to(dtype)


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of ``table``. A ``DTensor`` table is looked up on
    each card's blocks (``local_map``): a table split by vocabulary gives
    each rank the rows it holds (zeros for the others) and the result is
    a partial sum over the vocabulary's mesh dimensions, where indexing
    would gather the table; a whole table is indexed by each card's ids,
    and its gradient is a partial sum over the dimensions that split
    them."""
    if not isinstance(table, DTensor):
        return table[ids.long()]
    mesh = table.device_mesh
    rep = Replicate()
    tab_pl = [p if p.is_shard(0) else rep for p in table.placements]
    table = table.redistribute(mesh, tab_pl)
    v_dims = [i for i, p in enumerate(tab_pl) if p.is_shard(0)]
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [rep] * mesh.ndim,
                                 run_check=False)
    ids = ids.redistribute(mesh, [rep if i in v_dims or p.is_partial()
                                  else p
                                  for i, p in enumerate(ids.placements)])
    rows = table.shape[0] // math.prod(mesh.size(i) for i in v_dims)

    def lookup(tab, idx):
        if not v_dims:
            return tab[idx.long()]
        block = 0
        for i in v_dims:
            block = block * mesh.size(i) + mesh.get_local_rank(i)
        rel = idx.long() - block * rows
        hit = (rel >= 0) & (rel < rows)
        return torch.where(hit[..., None], tab[rel.clamp(0, rows - 1)], 0)

    out = [Partial() if i in v_dims else p
           for i, p in enumerate(ids.placements)]
    # each rank's ids give part of the table's gradient
    tab_grad = [p if i in v_dims else
                (Partial() if ids.placements[i].is_shard() else p)
                for i, p in enumerate(tab_pl)]
    return local_map(lookup, out_placements=out,
                     in_placements=(tuple(tab_pl), tuple(ids.placements)),
                     in_grad_placements=(tuple(tab_grad),
                                         tuple(ids.placements)),
                     device_mesh=mesh)(table, ids)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm scaled by ``(1 + weight)``, computed in fp32 and cast back."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., k] @ w [k, n]`` in ``x``'s dtype. A ``DTensor`` product
    whose weight is whole on every card and whose rows are split (the
    batch and a "seq" rule) runs as each card's own rows' product
    (``local_map``): some DTensor releases refuse to flatten two split
    row dimensions for the product."""
    w = w.to(x.dtype)
    if (isinstance(x, DTensor) and isinstance(w, DTensor)
            and all(p.is_replicate() for p in w.placements)
            and not any(p.is_shard(x.dim() - 1) or p.is_partial()
                        for p in x.placements)):
        grad_w = [Partial() if p.is_shard() else Replicate()
                  for p in x.placements]
        return local_map(torch.matmul, out_placements=list(x.placements),
                         in_placements=(tuple(x.placements),
                                        tuple(w.placements)),
                         in_grad_placements=(tuple(x.placements),
                                             tuple(grad_w)),
                         device_mesh=x.device_mesh)(x, w)
    return x @ w


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP. x:[...,d]; w_gate/w_up:[d,f]; w_down:[f,d]."""
    h = F.silu(linear(x, w_gate)) * linear(x, w_up)
    return linear(h, w_down)


def mlp_shapes(d: int, f: int, n_layers: int):
    """Shapes of ``n_layers`` stacked SwiGLU MLPs (``[in, out]``)."""
    return {"w_gate": (n_layers, d, f), "w_up": (n_layers, d, f),
            "w_down": (n_layers, f, d)}
