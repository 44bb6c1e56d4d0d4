"""Weight bridge: the JAX ``init_params`` pytree (``DecoderModel`` or
``EncDecModel``) as torch parameters.

``jax.random`` and ``torch.Generator`` give different numbers from the same
seed, so parity tests draw the weights once in JAX, turn the pytree into
nested dicts of numpy arrays, and hand them here. This module sees numpy
only; it never imports JAX.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models.api import param_shapes
from repro_torch.models.transformer import FP32_KEYS, model_dtype


def params_from_numpy(tree: Dict, cfg, *, device,
                      dtype: Optional[torch.dtype] = None) -> Dict:
    """Nested dict of numpy arrays -> nested dict of torch tensors on
    ``device``.

    Weight matrices and the embedding go to ``dtype`` (default: the
    config's); norm weights and the SSM's per-head constants stay fp32
    (``FP32_KEYS``). The stacked ``[L, ...]`` leaves and
    the ``[in, out]`` layout are kept as they are. Raises ``ValueError``
    when a key is missing or extra, or a shape differs from the config's.
    """
    dtype = dtype or model_dtype(cfg)

    def convert(sub, shapes, path):
        if set(sub) != set(shapes):
            raise ValueError(f"params{path}: keys {sorted(sub)} != "
                             f"expected {sorted(shapes)}")
        out = {}
        for k, want in shapes.items():
            if isinstance(want, dict):
                out[k] = convert(sub[k], want, f"{path}[{k!r}]")
                continue
            arr = np.asarray(sub[k])
            if arr.shape != tuple(want):
                raise ValueError(f"params{path}[{k!r}]: shape {arr.shape} "
                                 f"!= expected {tuple(want)}")
            dt = torch.float32 if k in FP32_KEYS else dtype
            # np.array copies: JAX hands over read-only buffers
            out[k] = torch.from_numpy(np.array(arr, np.float32)).to(
                device=device, dtype=dt)
        return out

    return convert(tree, param_shapes(cfg), "")
