"""Plain PyTorch reference of the planted qk-norm family: the dense
decoder (RMSNorm scaled by ``1 + w``, GQA with rotate-half RoPE, SwiGLU,
an untied head) with a per-head RMSNorm on q and k before RoPE. Float32,
TF32 off, a layer upcast at a time; ``quant="fp8"`` rounds both operands
of every matrix product to float8 e4m3. Imports nothing but torch."""
from typing import Dict, List, Optional, Sequence

import torch

FP8_MAX = 448.0


def _mm(x, w, quant):
    if quant == "fp8":
        def fp8(t, dim):
            scale = FP8_MAX / t.abs().amax(dim, keepdim=True).clamp_min(1e-12)
            return (t * scale).to(torch.float8_e4m3fn).float() / scale
        return fp8(x, -1) @ fp8(w, 0)
    return x @ w


def _norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x, theta):
    t, _, d = x.shape
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32) / half)
    ang = torch.arange(t, dtype=torch.float32)[:, None] * inv
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _layer(x, w: Dict, dims: Dict, quant):
    h, kvh, hd, eps = dims["h"], dims["kvh"], dims["hd"], dims["eps"]
    t = x.shape[0]
    a = _norm(x, w["ln1"], eps)
    q = _norm(_mm(a, w["wq"], quant).reshape(t, h, hd), w["q_norm"], eps)
    k = _norm(_mm(a, w["wk"], quant).reshape(t, kvh, hd), w["k_norm"], eps)
    q, k = _rope(q, dims["rope_theta"]), _rope(k, dims["rope_theta"])
    v = _mm(a, w["wv"], quant).reshape(t, kvh, hd)
    k = k.repeat_interleave(h // kvh, dim=1)
    v = v.repeat_interleave(h // kvh, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
    scores = scores.masked_fill(torch.ones(t, t).triu(1).bool(),
                                float("-inf"))
    attn = torch.einsum("hqk,khd->qhd", scores.softmax(-1), v)
    x = x + _mm(attn.reshape(t, h * hd), w["wo"], quant)
    m = _norm(x, w["ln2"], eps)
    gate = torch.nn.functional.silu(_mm(m, w["w_gate"], quant))
    return x + _mm(gate * _mm(m, w["w_up"], quant), w["w_down"], quant)


@torch.no_grad()
def served_logits(params: Dict, dims: Dict, seqs: Sequence[torch.Tensor],
                  starts: Sequence[int], quant: Optional[str] = None
                  ) -> List[torch.Tensor]:
    """Float32 logits at positions ``starts[i]-1 ...`` to the end of each
    sequence: the rows that predicted each served token (CPU only)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lp = params["layers"]
        xs = [params["embed"][s].float() for s in seqs]
        for i in range(dims["n_layers"]):
            w = {"ln1": lp["ln1"][i].float(), "ln2": lp["ln2"][i].float()}
            for group in ("attn", "mlp"):
                w.update({k: v[i].float() for k, v in lp[group].items()})
            xs = [_layer(x, w, dims, quant) for x in xs]
        norm, head = params["final_norm"].float(), params["head"].float()
        return [_mm(_norm(x[start - 1:], norm, dims["eps"]), head, quant)
                for x, start in zip(xs, starts)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
