"""Decoder-only model: the parameters and facts the paged executor reads.

The JAX package's ``DecoderModel`` also carries the slot-cache ``forward``
and the MoE/SSM/hybrid/MLA families. This slice holds only what
:class:`repro_torch.core.executor.PagedRealExecutor` reads: ``cfg``,
``n_stack``, ``n_dense``, ``is_mla``, ``dtype``, ``_stack_kind()`` and the
parameters of a dense ("mlp" kind) stack.

Parameters keep the reference layout: ``x @ W`` with ``[in, out]`` weights
and every per-layer leaf stacked along a leading ``L`` dimension. Weight
matrices and the embedding are stored once in the model's dtype (the JAX
package stores fp32 and casts at each use, which gives the same values);
norm weights stay fp32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.models.attention import attention_shapes
from repro_torch.models.layers import dense_init

# leaves stored fp32 whatever the model dtype (RMSNorm deltas from 1.0)
NORM_KEYS = frozenset(("ln1", "ln2", "final_norm", "q_norm", "k_norm"))


def model_dtype(cfg) -> torch.dtype:
    """The torch dtype a config computes in."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def param_shapes(cfg) -> Dict:
    """Nested dict of the shapes of a dense stack's parameters, as the JAX
    ``DecoderModel.init_params`` lays them out."""
    if cfg.arch_type != "dense" or cfg.is_moe or cfg.hybrid or cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: only dense-attention stacks are ported so far")
    d, f, v, n = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    attn = attention_shapes(cfg, n)
    shapes = {
        "embed": (v, d),
        "final_norm": (d,),
        "layers": {"ln1": (n, d), "ln2": (n, d), "attn": attn,
                   "mlp": {"w_gate": (n, d, f), "w_up": (n, d, f),
                           "w_down": (n, f, d)}},
    }
    if not cfg.tie_embeddings:
        shapes["head"] = (d, v)
    return shapes


def init_params(cfg, *, generator: torch.Generator, device) -> Dict:
    """Fresh weights drawn on ``device`` from ``generator``: the JAX
    package's scheme (truncated-normal fan-in, embedding at 0.02, norm
    deltas at 0), not its numbers."""
    dtype = model_dtype(cfg)

    def make(key, shape, stacked):
        if key in NORM_KEYS:
            return torch.zeros(shape, dtype=torch.float32, device=device)
        scale = 0.02 if key == "embed" else None
        if not stacked:
            return dense_init(shape, generator=generator, scale=scale,
                              dtype=dtype, device=device)
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):      # one layer at a time: fp32 scratch
            out[i] = dense_init(shape[1:], generator=generator, scale=scale,
                                dtype=dtype, device=device)
        return out

    def build(tree, stacked):
        return {k: (build(s, True) if isinstance(s, dict)
                    else make(k, s, stacked)) for k, s in tree.items()}

    return build(param_shapes(cfg), False)


def check_device(tree: Dict, device, what: str = "params") -> None:
    """Raise ``ValueError`` unless every tensor of ``tree`` lies on
    ``device`` (``"cuda"`` matches any card index)."""
    want = torch.device(device)
    for k, v in tree.items():
        if isinstance(v, dict):
            check_device(v, want, f"{what}[{k!r}]")
        elif v.device.type != want.type or (
                want.index is not None and v.device.index != want.index):
            raise ValueError(f"{what}[{k!r}] lies on {v.device}, not on "
                             f"{want}")


class _ParamTree(nn.Module):
    """A nested dict of tensors registered as frozen parameters."""

    def __init__(self, tree: Dict):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def as_dict(self) -> Dict:
        """The tree back as nested dicts of (parameter) tensors."""
        out = {}
        for k in self._keys:
            v = getattr(self, k)
            out[k] = v.as_dict() if isinstance(v, _ParamTree) else v
        return out


class DecoderModel(nn.Module):
    """Dense decoder whose stacked ``[L, ...]`` parameters the paged
    executor reads layer by layer.

    ``params`` is a nested dict of tensors (from
    :func:`repro_torch.models.bridge.params_from_numpy`, or
    :func:`init_params`) and must lie on ``device``; without it the
    weights are drawn on ``device`` from ``generator``.
    """

    def __init__(self, cfg, params: Optional[Dict] = None, *,
                 device, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.n_dense = cfg.moe_dense_layers if cfg.is_moe else 0
        self.n_stack = cfg.n_layers - self.n_dense
        self.is_mla = cfg.mla_kv_lora_rank > 0
        self.dtype = model_dtype(cfg)
        if params is None:
            if generator is None:
                raise ValueError("DecoderModel needs params or a generator")
            params = init_params(cfg, generator=generator, device=device)
        else:
            check_device(params, device)
        self.tree = _ParamTree(params)

    @property
    def params(self) -> Dict:
        """Nested dict view of the parameters (the JAX pytree's layout)."""
        return self.tree.as_dict()

    def _stack_kind(self) -> str:
        cfg = self.cfg
        if cfg.arch_type == "ssm":
            return "ssm"
        if cfg.hybrid:
            return "hybrid"
        if cfg.is_moe:
            return "moe"
        return "mlp"
