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

Not ported: the JAX package's expert-parallel ``shard_map`` dispatch,
which runs only under a TPU mesh with an ``experts`` rule.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.layers import mlp_shapes, swiglu

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
    xt = x.reshape(t, d)
    probs, gate_w, gate_idx = route(p, cfg, xt)

    # load-balance auxiliary loss (Switch-style)
    ce = torch.bincount(gate_idx.reshape(-1), minlength=e).float() / (t * k)
    aux = e * torch.sum(probs.mean(0) * ce)

    pairs, kept, _ = dispatch(gate_idx, e, capacity(t, cfg, exact))
    tok = pairs // k
    xs = xt[tok]                                  # kept rows, by expert
    ys, off = [], 0
    for ei, n in enumerate(kept.tolist()):
        if n:
            ys.append(swiglu(xs[off:off + n], p["w_gate"][ei],
                             p["w_up"][ei], p["w_down"][ei]))
            off += n
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    if ys:
        w = gate_w.reshape(-1)[pairs].to(x.dtype).float()
        out.index_add_(0, tok, torch.cat(ys).float() * w[:, None])
    out = out.to(x.dtype)
    for i in range(cfg.n_shared_experts):
        sp = p[f"shared_{i}"]
        out = out + swiglu(xt, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out.reshape(b, s, d), aux


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
