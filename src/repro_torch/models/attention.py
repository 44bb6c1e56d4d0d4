"""Attention parameters of a dense GQA layer.

The counterpart of the JAX package's ``models/attention.py::init_attention``
for what the paged executor reads. The attention arithmetic itself runs in
:mod:`repro_torch.kernels`; the slot-cache attention path, MLA and the
encoder/cross attention are still to be ported.
"""
from __future__ import annotations

from typing import Dict, Tuple


def attention_shapes(cfg, n_layers: int) -> Dict[str, Tuple[int, ...]]:
    """Shapes of ``n_layers`` stacked attention blocks: ``wq/wk/wv`` are
    ``[d, heads * head_dim]`` and ``wo`` is ``[H * head_dim, d]``, plus the
    per-head qk-norm deltas where the config has them."""
    if cfg.mla_kv_lora_rank:
        raise NotImplementedError("MLA attention is not ported yet")
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (n_layers, d, h * hd), "wk": (n_layers, d, kv * hd),
              "wv": (n_layers, d, kv * hd), "wo": (n_layers, h * hd, d)}
    if cfg.qk_norm:
        shapes["q_norm"] = (n_layers, hd)
        shapes["k_norm"] = (n_layers, hd)
    return shapes
