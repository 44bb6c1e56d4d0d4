"""Decoder-only model: parameters, the slot cache and the serving forward.

The counterpart of the JAX package's ``models/transformer.py`` for every
decoder stack kind: dense ("mlp": sliding windows, qk-norm and M-RoPE
included), MoE ("moe": leading dense layers, then routed-expert layers),
GQA or MLA attention, attention-free SSM ("ssm": mamba2 blocks only) and
hybrid ("hybrid": attention and SSM branches in parallel in every layer):
the parameters and facts the paged executor reads (``cfg``, ``n_stack``,
``n_dense``, ``is_mla``, ``dtype``, ``_stack_kind()``), and the slot
executor's ``init_cache`` and ``forward(..., train=False)``. The
encoder-decoder model is :mod:`repro_torch.models.encdec`; the training
forward is still to be ported and raises ``NotImplementedError``.

Parameters keep the reference layout: ``x @ W`` with ``[in, out]`` weights
and every per-layer leaf stacked along a leading ``L`` dimension. Weight
matrices and the embedding are stored once in the model's dtype (the JAX
package stores fp32 and casts at each use, which gives the same values);
norm weights and the SSM's per-head constants stay fp32 (``FP32_KEYS``).
The JAX package runs the stacked layers with ``lax.scan`` and returns a
new cache; here a Python loop walks the layers and the cache tensors are
written in place (a full-width slot cache is gigabytes), the SSM state
included: only the rows of the batch are read and written.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.attention import attention_shapes
from repro_torch.models.layers import (dense_init, mlp_shapes, rmsnorm,
                                       swiglu)
from repro_torch.models.moe import EXPERT_KEYS, moe_block, moe_shapes
from repro_torch.models.ssm import (FP32_SSM_KEYS, SSM_FIXED_INIT,
                                    SSM_INIT_SCALE, ssm_block, ssm_dims,
                                    ssm_shapes)

# RMSNorm weights (deltas from 1.0), of every model family
NORM_KEYS = frozenset(("ln1", "ln2", "final_norm", "q_norm", "k_norm",
                       "kv_norm", "gate_norm", "ln_attn_out", "ln_ssm_out",
                       "enc_final_norm", "ln_cross"))
# leaves stored fp32 whatever the model dtype: the norms and the SSM's
# per-head constants, which the JAX package keeps and reads in fp32
FP32_KEYS = NORM_KEYS | FP32_SSM_KEYS


def model_dtype(cfg) -> torch.dtype:
    """The torch dtype a config computes in."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def stack_kind(cfg) -> str:
    """The kind of the stacked layers, as the JAX ``_stack_kind``."""
    if cfg.arch_type == "ssm":
        return "ssm"
    if cfg.hybrid:
        return "hybrid"
    if cfg.is_moe:
        return "moe"
    return "mlp"


def _layer_shapes(cfg, kind: str, n: int) -> Dict:
    """``n`` stacked layers of ``kind``: "mlp", "dense_mlp" (an MoE
    model's leading dense layers, ``moe_dense_d_ff`` wide), "moe", "ssm"
    (``ln1`` and the SSM block only) or "hybrid" (attention and SSM
    branches, each with its output norm, then the MLP)."""
    d = cfg.d_model
    if kind == "ssm":
        return {"ln1": (n, d), "ssm": ssm_shapes(cfg, n)}
    shapes = {"ln1": (n, d), "ln2": (n, d), "attn": attention_shapes(cfg, n)}
    if kind == "hybrid":
        shapes.update(ssm=ssm_shapes(cfg, n), ln_attn_out=(n, d),
                      ln_ssm_out=(n, d))
    if kind == "moe":
        shapes["moe"] = moe_shapes(cfg, n)
    else:
        f = (cfg.moe_dense_d_ff or cfg.d_ff) if kind == "dense_mlp" \
            else cfg.d_ff
        shapes["mlp"] = mlp_shapes(d, f, n)
    return shapes


def param_shapes(cfg) -> Dict:
    """Nested dict of the shapes of a decoder's parameters (dense, VLM,
    MoE, SSM and hybrid families, GQA or MLA attention), as the JAX
    ``DecoderModel.init_params`` lays them out. An encoder-decoder config
    raises ``ValueError``: its layout is
    :func:`repro_torch.models.encdec.param_shapes`."""
    if cfg.enc_dec:
        raise ValueError(f"{cfg.name} is an encoder-decoder: see "
                         "repro_torch.models.encdec")
    # a VLM is a dense "mlp" stack fed by a frontend (the JAX package's
    # ``_stack_kind``); its embedding and head are laid out all the same
    kind = stack_kind(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    n_dense = cfg.moe_dense_layers if cfg.is_moe else 0
    shapes = {"embed": (v, d), "final_norm": (d,),
              "layers": _layer_shapes(cfg, kind, cfg.n_layers - n_dense)}
    if n_dense:
        shapes["dense_layers"] = _layer_shapes(cfg, "dense_mlp", n_dense)
    if not cfg.tie_embeddings:
        shapes["head"] = (d, v)
    return shapes


def init_params(cfg, *, generator: torch.Generator, device) -> Dict:
    """Fresh weights drawn on ``device`` from ``generator``: the JAX
    package's scheme (truncated-normal fan-in, so the router's scale is
    ``d ** -0.5``; embedding at 0.02, norm deltas at 0, the SSM's fixed
    constants and its convolution at 0.3), not its numbers."""
    return draw_params(param_shapes(cfg), model_dtype(cfg),
                       generator=generator, device=device)


def draw_params(shapes: Dict, dtype: torch.dtype, *,
                generator: torch.Generator, device) -> Dict:
    """Draw a parameter tree of ``shapes`` (see :func:`init_params`).
    Stacked leaves are drawn one layer at a time, and the routed experts'
    ``[E, d, f]`` leaves one expert at a time, so the fp32 scratch stays
    one matrix (one layer of kimi-k2's ``w_gate`` would be 21 GiB)."""

    def make(key, shape, lead):
        if key in NORM_KEYS:
            return torch.zeros(shape, dtype=torch.float32, device=device)
        if key in SSM_FIXED_INIT:
            return SSM_FIXED_INIT[key](shape[-1]).to(device).expand(
                shape).contiguous()
        scale = 0.02 if key == "embed" else SSM_INIT_SCALE.get(key)
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in itertools.product(*map(range, shape[:lead])):
            out[i] = dense_init(shape[lead:], generator=generator,
                                scale=scale, dtype=dtype, device=device)
        return out

    def build(tree, lead):
        out = {}
        for k, s in tree.items():
            if isinstance(s, dict):
                out[k] = build(s, 1)
            else:
                routed = lead and k in EXPERT_KEYS and len(s) == 4
                out[k] = make(k, s, 2 if routed else lead)
        return out

    return build(shapes, 0)


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


def cache_positions(cache: Dict, cache_len: torch.Tensor, s: int,
                    positions: Optional[torch.Tensor],
                    kv_positions: Optional[torch.Tensor],
                    rows: Optional[torch.Tensor]):
    """The query positions (default ``cache_len + arange(s)``), the
    batch's post-write cache positions and the write slots of a serving
    forward; the cache's position buffer is updated in place at the
    batch's rows (from ``kv_positions`` when the host manages them)."""
    b = cache_len.shape[0]
    dev = cache_len.device
    if positions is None:
        positions = cache_len[:, None] + torch.arange(
            s, dtype=cache_len.dtype, device=dev)[None, :]
    idx = attn.write_indices(cache_len, s, cache["pos"].shape[1])
    pos_rows = torch.arange(b, device=dev) if rows is None else rows
    if kv_positions is None:
        attn.scatter_tokens(cache["pos"], positions, idx, pos_rows)
    else:
        cache["pos"][pos_rows] = kv_positions.to(cache["pos"].dtype)
    return positions, cache["pos"][pos_rows], idx


def layer_slice(tree: Dict, i: int) -> Dict:
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


class DecoderModel(nn.Module):
    """Decoder of any stack kind: stacked ``[L, ...]`` parameters that
    the paged executor reads layer by layer, and the slot-cache serving
    forward.

    ``params`` is a nested dict of tensors (from
    :func:`repro_torch.models.bridge.params_from_numpy`, or
    :func:`init_params`) and must lie on ``device``; without it the
    weights are drawn on ``device`` from ``generator``. ``exact_moe``
    runs the MoE layers without capacity drops, as serving does (the
    JAX constructor's keyword and default).
    """

    def __init__(self, cfg, params: Optional[Dict] = None, *,
                 device, generator: Optional[torch.Generator] = None,
                 exact_moe: bool = False):
        super().__init__()
        self.cfg = cfg
        self.exact_moe = exact_moe
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
        return stack_kind(self.cfg)

    # ------------------------------------------------------------------
    # the slot cache and the serving forward
    # ------------------------------------------------------------------
    def _attn_cache(self, n: int, batch: int, s_kv: int) -> Dict:
        """``n`` stacked layers' attention cache: ``k``/``v`` of ``[n,
        batch, s_kv, Kv, D]``, or MLA's latent ``ckv [n, batch, s_kv,
        r_kv]`` and rope key ``kpe [n, batch, s_kv, hd_r]``."""
        cfg = self.cfg
        if self.is_mla:
            tails = {"ckv": (cfg.mla_kv_lora_rank,),
                     "kpe": (cfg.mla_rope_head_dim,)}
        else:
            tails = dict.fromkeys(("k", "v"), (cfg.n_kv_heads, cfg.head_dim))
        return {k: torch.zeros((n, batch, s_kv) + t, dtype=self.dtype,
                               device=self.tree.embed.device)
                for k, t in tails.items()}

    def _ssm_cache(self, n: int, batch: int) -> Dict:
        """``n`` stacked layers' recurrent state: ``h [n, batch, H, P, N]``
        fp32 and the convolution's carry ``conv [n, batch, W-1,
        conv_dim]`` in the model's dtype."""
        _, h, p, ns, conv_dim = ssm_dims(self.cfg)
        dev = self.tree.embed.device
        return {"h": torch.zeros((n, batch, h, p, ns), dtype=torch.float32,
                                 device=dev),
                "conv": torch.zeros((n, batch, self.cfg.ssm_conv_width - 1,
                                     conv_dim), dtype=self.dtype,
                                    device=dev)}

    def init_cache(self, batch: int, s_kv: int) -> Dict:
        """Zeroed slot cache on the model's device and in its dtype:
        ``pos [batch, s_kv]`` int32 (-1 = empty), the stacked layers'
        attention cache (none for "ssm") and SSM state ("ssm", "hybrid")
        under ``stack`` and, for an MoE model's leading dense layers, their
        attention cache under ``dense``."""
        kind = self._stack_kind()
        stack = {}
        if kind != "ssm":
            stack.update(self._attn_cache(self.n_stack, batch, s_kv))
        if kind in ("ssm", "hybrid"):
            stack.update(self._ssm_cache(self.n_stack, batch))
        cache = {"pos": torch.full((batch, max(s_kv, 1)), -1,
                                   dtype=torch.int32,
                                   device=self.tree.embed.device),
                 "stack": stack}
        if self.n_dense:
            cache["dense"] = self._attn_cache(self.n_dense, batch, s_kv)
        return cache

    def embed_inputs(self, params: Dict, inputs: torch.Tensor
                     ) -> torch.Tensor:
        """Token ids ``[B, S]`` -> embeddings; ``[B, S, d]`` embeddings
        (a frontend's output) pass through in the model's dtype."""
        if inputs.dim() == 3:
            return inputs.to(self.dtype)
        return params["embed"].to(self.dtype)[inputs.long()]

    def _ssm(self, p: Dict, h, lc: Dict, rows, decode: bool,
             token_mask):
        """The SSM block on the batch's rows of the layer's state, which it
        writes back in place."""
        b = h.shape[0]
        sel = torch.arange(b, device=h.device) if rows is None else rows
        state = {k: lc[k].index_select(0, sel) for k in ("h", "conv")}
        out, new = ssm_block(p, self.cfg, h, state, decode=decode,
                             token_mask=token_mask)
        for k in ("h", "conv"):
            lc[k].index_copy_(0, sel, new[k].to(lc[k].dtype))
        return out

    def _layer(self, kind: str, lp: Dict, x, positions, kv_pos, idx, lc,
               width, rows, aux, decode):
        """One layer: attention (GQA or MLA) over the cache, then SwiGLU
        or, for the "moe" kind, the MoE block, whose loss adds to
        ``aux``; an "ssm" layer is the SSM block alone, a "hybrid" layer
        averages the RMS-normed attention and SSM branches before its
        MLP. Padding tokens (position -1) leave the SSM state as it was."""
        cfg = self.cfg
        token_mask = positions >= 0
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if kind == "ssm":
            return x + self._ssm(lp["ssm"], h, lc, rows, decode,
                                 token_mask), aux
        fn = attn.mla_attention_block if self.is_mla \
            else attn.attention_block
        a_out, _ = fn(lp["attn"], cfg, h, positions, kv_pos, idx, lc, width,
                      rows)
        if kind == "hybrid":
            s_out = self._ssm(lp["ssm"], h, lc, rows, decode, token_mask)
            x = x + 0.5 * (rmsnorm(a_out, lp["ln_attn_out"], cfg.norm_eps)
                           + rmsnorm(s_out, lp["ln_ssm_out"], cfg.norm_eps))
        else:
            x = x + a_out
        h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        if kind == "moe":
            m_out, a = moe_block(lp["moe"], cfg, h2, exact=self.exact_moe)
            return x + m_out, aux + a
        return x + swiglu(h2, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                          lp["mlp"]["w_down"]), aux

    def _run_stack(self, kind: str, stacked: Dict, first: int, x,
                   positions, kv_pos, idx, stack_cache: Dict, rows, aux,
                   decode):
        """The stacked layers in order (``first``: the model index of the
        first, for its window), each writing its cache in place."""
        for i in range(next(iter(stack_cache.values())).shape[0]):
            lc = {k: a[i] for k, a in stack_cache.items()}
            x, aux = self._layer(kind, layer_slice(stacked, i), x,
                                 positions, kv_pos, idx, lc,
                                 self.cfg.layer_window(first + i), rows,
                                 aux, decode)
        return x, aux

    def forward(self, params: Dict, inputs: torch.Tensor, cache: Dict,
                cache_len: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                kv_positions: Optional[torch.Tensor] = None,
                decode: bool = False, train: bool = False,
                rows: Optional[torch.Tensor] = None):
        """Serving forward over the slot cache, written in place.

        inputs: tokens ``[b, S]`` or embeddings ``[b, S, d]``; cache_len
        ``[b]``: tokens already cached per row (sets the write slots);
        positions ``[b, S]`` (default ``cache_len + arange(S)``; -1 marks
        padding); ``kv_positions [b, S_kv]``: host-managed post-write
        cache positions (serving engines), else the cache's own position
        buffer is updated and used. ``decode`` with one token per row
        takes the SSM's recurrent step (the chunked scan otherwise).
        ``rows`` (int64 ``[b]``) are the cache rows the batch maps to
        (default: the first ``b``); other rows are neither read nor
        written, recurrent state included. Returns ``(logits [b, S, V],
        cache, aux)``; ``aux`` is the MoE layers' summed load-balance
        loss (fp32; 0 without MoE).
        """
        if train:
            raise NotImplementedError(
                "the training forward (train=True) comes with the training "
                "slice (queue 1 item 11)")
        cfg = self.cfg
        x = self.embed_inputs(params, inputs)
        positions, kv_pos, idx = cache_positions(
            cache, cache_len, x.shape[1], positions, kv_positions, rows)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.n_dense:
            x, aux = self._run_stack("dense_mlp", params["dense_layers"], 0,
                                     x, positions, kv_pos, idx,
                                     cache["dense"], rows, aux, decode)
        x, aux = self._run_stack(self._stack_kind(), params["layers"],
                                 self.n_dense, x, positions, kv_pos, idx,
                                 cache["stack"], rows, aux, decode)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        logits = x @ head.to(x.dtype)
        return logits, cache, aux
