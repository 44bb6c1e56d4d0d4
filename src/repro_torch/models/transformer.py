"""Decoder-only model: parameters, the slot cache and the serving forward.

The counterpart of the JAX package's ``models/transformer.py`` for a dense
("mlp" kind) stack: the parameters and facts the paged executor reads
(``cfg``, ``n_stack``, ``n_dense``, ``is_mla``, ``dtype``,
``_stack_kind()``), and the slot executor's ``init_cache`` and
``forward(..., train=False)``. The MoE/SSM/hybrid/MLA/encoder-decoder
families (refused when their parameters are laid out) and the training
forward are still to be ported and raise ``NotImplementedError``.

Parameters keep the reference layout: ``x @ W`` with ``[in, out]`` weights
and every per-layer leaf stacked along a leading ``L`` dimension. Weight
matrices and the embedding are stored once in the model's dtype (the JAX
package stores fp32 and casts at each use, which gives the same values);
norm weights stay fp32. The JAX package runs the stacked layers with
``lax.scan`` and returns a new cache; here a Python loop walks the layers
and the cache tensors are written in place (a full-width slot cache is
gigabytes).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.attention import attention_shapes
from repro_torch.models.layers import dense_init, rmsnorm, swiglu

# leaves stored fp32 whatever the model dtype (RMSNorm deltas from 1.0)
NORM_KEYS = frozenset(("ln1", "ln2", "final_norm", "q_norm", "k_norm"))


def model_dtype(cfg) -> torch.dtype:
    """The torch dtype a config computes in."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def param_shapes(cfg) -> Dict:
    """Nested dict of the shapes of a dense stack's parameters (dense and
    VLM families), as the JAX ``DecoderModel.init_params`` lays them
    out."""
    # a VLM is a dense "mlp" stack fed by a frontend (the JAX package's
    # ``_stack_kind``); its embedding and head are laid out all the same
    if (cfg.arch_type not in ("dense", "vlm") or cfg.is_moe or cfg.hybrid
            or cfg.enc_dec):
        raise NotImplementedError(
            f"{cfg.name}: only dense-attention stacks are ported so far "
            "(MoE, SSM/hybrid, MLA and encoder-decoder come with ROADMAP.md "
            "queue 1 items 7-10)")
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


def _layer_slice(tree: Dict, i: int) -> Dict:
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return {k: _layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


class DecoderModel(nn.Module):
    """Dense decoder: stacked ``[L, ...]`` parameters that the paged
    executor reads layer by layer, and the slot-cache serving forward.

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

    # ------------------------------------------------------------------
    # the slot cache and the serving forward
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, s_kv: int) -> Dict:
        """Zeroed slot cache: ``pos [batch, s_kv]`` int32 (-1 = empty) and
        the stacked ``k``/``v`` of ``[L, batch, s_kv, Kv, D]``, on the
        model's device and in its dtype."""
        cfg = self.cfg
        dev = self.tree.embed.device
        shape = (self.n_stack, batch, s_kv, cfg.n_kv_heads, cfg.head_dim)
        return {"pos": torch.full((batch, max(s_kv, 1)), -1,
                                  dtype=torch.int32, device=dev),
                "stack": {"k": torch.zeros(shape, dtype=self.dtype,
                                           device=dev),
                          "v": torch.zeros(shape, dtype=self.dtype,
                                           device=dev)}}

    def embed_inputs(self, params: Dict, inputs: torch.Tensor
                     ) -> torch.Tensor:
        """Token ids ``[B, S]`` -> embeddings; ``[B, S, d]`` embeddings
        (a frontend's output) pass through in the model's dtype."""
        if inputs.dim() == 3:
            return inputs.to(self.dtype)
        return params["embed"].to(self.dtype)[inputs.long()]

    def _layer(self, lp: Dict, x, positions, kv_pos, idx, lc, width, rows):
        """One dense layer: attention over the cache, then SwiGLU."""
        cfg = self.cfg
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a_out, _ = attn.attention_block(lp["attn"], cfg, h, positions,
                                        kv_pos, idx, lc, width, rows)
        x = x + a_out
        h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        return x + swiglu(h2, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                          lp["mlp"]["w_down"])

    def _run_stack(self, stacked: Dict, x, positions, kv_pos, idx,
                   stack_cache: Dict, rows):
        """The stacked layers in order, each writing its cache in place."""
        for i in range(self.n_stack):
            lc = {k: stack_cache[k][i] for k in ("k", "v")}
            x = self._layer(_layer_slice(stacked, i), x, positions, kv_pos,
                            idx, lc, self.cfg.layer_window(self.n_dense + i),
                            rows)
        return x

    def forward(self, params: Dict, inputs: torch.Tensor, cache: Dict,
                cache_len: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                kv_positions: Optional[torch.Tensor] = None,
                train: bool = False, rows: Optional[torch.Tensor] = None):
        """Serving forward over the slot cache, written in place.

        inputs: tokens ``[b, S]`` or embeddings ``[b, S, d]``; cache_len
        ``[b]``: tokens already cached per row (sets the write slots);
        positions ``[b, S]`` (default ``cache_len + arange(S)``; -1 marks
        padding); ``kv_positions [b, S_kv]``: host-managed post-write
        cache positions (serving engines), else the cache's own position
        buffer is updated and used. ``rows`` (int64 ``[b]``) are the
        cache rows the batch maps to (default: the first ``b``); other
        rows are neither read nor written. Returns ``(logits [b, S, V],
        cache, aux)``; ``aux`` is 0 (no MoE).
        """
        if train:
            raise NotImplementedError(
                "the training forward (train=True) comes with the training "
                "slice (queue 1 item 11)")
        cfg = self.cfg
        x = self.embed_inputs(params, inputs)
        b, s, _ = x.shape
        dev = x.device
        if positions is None:
            positions = cache_len[:, None] + torch.arange(
                s, dtype=cache_len.dtype, device=dev)[None, :]
        s_kv = cache["pos"].shape[1]
        idx = attn.write_indices(cache_len, s, s_kv)
        pos_rows = (torch.arange(b, device=dev) if rows is None else rows)
        if kv_positions is None:
            attn.scatter_tokens(cache["pos"], positions, idx, pos_rows)
        else:
            cache["pos"][pos_rows] = kv_positions.to(cache["pos"].dtype)
        kv_pos = cache["pos"][pos_rows]
        x = self._run_stack(params["layers"], x, positions, kv_pos, idx,
                            cache["stack"], rows)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        logits = x @ head.to(x.dtype)
        return logits, cache, torch.zeros((), dtype=torch.float32,
                                          device=dev)
