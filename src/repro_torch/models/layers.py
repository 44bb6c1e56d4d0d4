"""Basic layers: RMSNorm, SwiGLU MLP, its shapes and the truncated-normal
init."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


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


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm scaled by ``(1 + weight)``, computed in fp32 and cast back."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP. x:[...,d]; w_gate/w_up:[d,f]; w_down:[f,d]."""
    h = F.silu(x @ w_gate.to(x.dtype)) * (x @ w_up.to(x.dtype))
    return h @ w_down.to(x.dtype)


def mlp_shapes(d: int, f: int, n_layers: int):
    """Shapes of ``n_layers`` stacked SwiGLU MLPs (``[in, out]``)."""
    return {"w_gate": (n_layers, d, f), "w_up": (n_layers, d, f),
            "w_down": (n_layers, f, d)}
