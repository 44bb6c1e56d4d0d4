"""Plain PyTorch reference of the dense decoder the cells serve.

A full causal forward in float32, with no cache, no kernels and no
batching, over a request's prompt followed by the tokens the program
served: Qwen2 / Llama decoder layers (RMSNorm, grouped-query attention
with rotate-half RoPE on split halves, SwiGLU), a final norm and an
untied head. The norms scale by ``1 + w``, which is the published
``x · w`` with ``w`` stored as its offset from 1. Published parts the
served model leaves out are listed as ``departures`` in each
configuration's file.

The weights stay in the type they were drawn in; each layer is upcast to
float32 when it runs, so a model that fills most of the card is checked
without a second copy of it. TF32 is switched off while it runs.

``quant="fp8"`` is the control: the same forward with every matrix
product's two operands rounded to float8 e4m3 (a scale a weight column
and an activation row, as an fp8 GEMM would take them), accumulated in
float32.

Imports nothing but torch: not the program, not the JAX package.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

Q_BLOCK = 1024           # query rows of attention scores at a time
FP8_MAX = 448.0          # largest finite float8 e4m3 value


@contextlib.contextmanager
def no_tf32():
    """Full float32 matrix products inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one absmax scale per slice along
    ``dim``, returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]):
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, heads, D] at positions 0..T-1; pairs are the two halves."""
    t, _, d = x.shape
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v):
    """Causal GQA: q [T, H, D], k/v [T, Kv, D] -> [T, H·D]."""
    t, h, d = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    for s in range(0, t, Q_BLOCK):
        e = min(s + Q_BLOCK, t)
        scores = torch.einsum("qhd,khd->hqk", q[s:e], k[:e]) * d ** -0.5
        mask = (torch.arange(e, device=q.device)[None]
                > torch.arange(s, e, device=q.device)[:, None])
        scores.masked_fill_(mask[None], float("-inf"))
        out[s:e] = torch.einsum("hqk,khd->qhd", scores.softmax(-1), v[:e])
    return out.reshape(t, h * d)


def _layer(x, lw: Dict, dims: Dict, quant):
    h, kvh, hd, eps = dims["h"], dims["kvh"], dims["hd"], dims["eps"]
    t = x.shape[0]
    a = _rmsnorm(x, lw["ln1"], eps)
    q = _rope(_mm(a, lw["wq"], quant).reshape(t, h, hd), dims["rope_theta"])
    k = _rope(_mm(a, lw["wk"], quant).reshape(t, kvh, hd), dims["rope_theta"])
    v = _mm(a, lw["wv"], quant).reshape(t, kvh, hd)
    x = x + _mm(_attention(q, k, v), lw["wo"], quant)
    m = _rmsnorm(x, lw["ln2"], eps)
    gate = torch.nn.functional.silu(_mm(m, lw["w_gate"], quant))
    return x + _mm(gate * _mm(m, lw["w_up"], quant), lw["w_down"], quant)


def _layer_weights(params: Dict, i: int) -> Dict:
    lp = params["layers"]
    out = {"ln1": lp["ln1"][i].float(), "ln2": lp["ln2"][i].float()}
    for group in ("attn", "mlp"):
        for key, w in lp[group].items():
            out[key] = w[i].float()
    return out


@torch.no_grad()
def served_logits(params: Dict, dims: Dict, seqs: Sequence[torch.Tensor],
                  starts: Sequence[int], quant: Optional[str] = None
                  ) -> List[torch.Tensor]:
    """Float32 logits at positions ``starts[i]-1 ...`` to the end of each
    token sequence ``seqs[i]`` (a prompt and the served tokens but the
    last): the rows that predicted each served token. Layer by layer over
    all sequences, each layer upcast once."""
    with no_tf32():
        xs = [params["embed"][s].float() for s in seqs]
        for i in range(dims["n_layers"]):
            lw = _layer_weights(params, i)
            xs = [_layer(x, lw, dims, quant) for x in xs]
            del lw
        norm = params["final_norm"].float()
        head = params["head"].float()
        out = []
        for x, start in zip(xs, starts):
            rows = _rmsnorm(x[start - 1:], norm, dims["eps"])
            out.append(_mm(rows, head, quant))
        return out
