"""Decoder-only model: parameters, the slot cache and the serving forward.

The counterpart of the JAX package's ``models/transformer.py`` for every
decoder stack kind: dense ("mlp": sliding windows, qk-norm and M-RoPE
included), MoE ("moe": leading dense layers, then routed-expert layers),
GQA or MLA attention, attention-free SSM ("ssm": mamba2 blocks only) and
hybrid ("hybrid": attention and SSM branches in parallel in every layer):
the parameters and facts the paged executor reads (``cfg``, ``n_stack``,
``n_dense``, ``is_mla``, ``dtype``, ``_stack_kind()``), and the slot
executor's ``init_cache`` and ``forward(..., train=False)``, and the
training forward (``train=True``: no cache, each layer recomputed in the
backward pass when ``remat``) and ``loss``. The encoder-decoder model is
:mod:`repro_torch.models.encdec`.

Parameters keep the reference layout: ``x @ W`` with ``[in, out]`` weights
and every per-layer leaf stacked along a leading ``L`` dimension. Weight
matrices and the embedding are stored once in the model's dtype (the JAX
package stores fp32 and casts at each use, which gives the same values);
norm weights and the SSM's per-head constants stay fp32 (``FP32_KEYS``).
Training holds fp32 master weights, as the JAX package does, and every
use site casts them to the compute dtype. The JAX package runs the
stacked layers with ``lax.scan`` and returns a new cache; here a Python
loop walks the layers and the cache tensors are written in place (a
full-width slot cache is gigabytes), the SSM state included: only the
rows of the batch are read and written.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.attention import attention_shapes
from repro_torch.models.collectives import block_sizes, reduce_from_group
from repro_torch.models.layers import (dense_init, embed, linear,
                                       mlp_shapes, rmsnorm, swiglu)
from repro_torch.models.moe import EXPERT_KEYS, moe_block, moe_shapes
from repro_torch.models.sharding import (axis_group, get_mesh, get_rules,
                                         maybe_shard)
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
    pos = cache["pos"]
    if kv_positions is None:
        attn.scatter_tokens(pos, positions, idx, rows)
    elif rows is None:
        pos[:b] = kv_positions.to(pos.dtype)
    else:
        pos[rows] = kv_positions.to(pos.dtype)
    return positions, (pos[:b] if rows is None else pos[rows]), idx


def layer_slice(tree: Dict, i: int) -> Dict:
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def unstack_layers(tree: Dict) -> list:
    """Every layer of a stacked parameter tree, in order (views, no
    copies). One ``unbind`` per leaf: its backward stacks the layers'
    gradients once, where indexing each layer apart would give every
    layer a zero-filled gradient of the whole stack to add up (bytes
    quadratic in depth)."""
    per = {k: unstack_layers(v) if isinstance(v, dict) else v.unbind(0)
           for k, v in tree.items()}
    n = len(next(iter(per.values())))
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


class DecoderModel(nn.Module):
    """Decoder of any stack kind: stacked ``[L, ...]`` parameters that
    the paged executor reads layer by layer, and the slot-cache serving
    forward.

    ``params`` is a nested dict of tensors (from
    :func:`repro_torch.models.bridge.params_from_numpy`, or
    :func:`init_params`) and must lie on ``device``; without it the
    weights are drawn on ``device`` from ``generator``. ``exact_moe``
    runs the MoE layers without capacity drops, as serving does (the
    JAX constructor's keyword and default). ``remat`` recomputes each
    layer of the training forward in the backward pass
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``).
    ``window_override`` gives every layer that attention window in place
    of the config's (the dry-run's sliding-window variant).
    """

    def __init__(self, cfg, params: Optional[Dict] = None, *,
                 device, generator: Optional[torch.Generator] = None,
                 exact_moe: bool = False, remat: bool = True,
                 window_override: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.exact_moe = exact_moe
        self.remat = remat
        self.window_override = window_override
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

    def layer_window(self, i: int) -> int:
        """Layer ``i``'s attention window (0 = full attention)."""
        if self.window_override is not None:
            return self.window_override
        return self.cfg.layer_window(i)

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

    def _ssm_cache(self, n: int, batch: int, device=None) -> Dict:
        """``n`` stacked layers' recurrent state: ``h [n, batch, H, P, N]``
        fp32 and the convolution's carry ``conv [n, batch, W-1,
        conv_dim]`` in the model's dtype, zeroed on ``device`` (default:
        the weights')."""
        _, h, p, ns, conv_dim = ssm_dims(self.cfg)
        dev = device or self.tree.embed.device
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
        return embed(params["embed"].to(self.dtype), inputs)

    def _ssm(self, p: Dict, h, lc: Optional[Dict], rows, decode: bool,
             token_mask):
        """The SSM block on the batch's rows of the layer's state, which it
        writes back in place; without ``lc`` (training) it starts from
        zero state and keeps none."""
        b = h.shape[0]
        if lc is None:
            zero = {k: v[0] for k, v in self._ssm_cache(
                1, b, h.device).items()}
            return ssm_block(p, self.cfg, h, zero)[0]
        if rows is None and lc["h"].shape[0] == b:
            # the whole batch: the state as it is, written back whole
            out, new = ssm_block(p, self.cfg, h, lc, decode=decode,
                                 token_mask=token_mask)
            for k in ("h", "conv"):
                lc[k].copy_(new[k].to(lc[k].dtype))
            return out
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
        MLP. Padding tokens (position -1) leave the SSM state as it was.
        ``lc=None`` is the cache-free training layer."""
        cfg = self.cfg
        token_mask = None if lc is None else positions >= 0
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if kind == "ssm":
            return x + _stream(self._ssm(lp["ssm"], h, lc, rows, decode,
                                         token_mask)), aux
        fn = attn.mla_attention_block if self.is_mla \
            else attn.attention_block
        a_out, _ = fn(lp["attn"], cfg, h, positions, kv_pos, idx, lc, width,
                      rows)
        a_out = _stream(a_out)
        if kind == "hybrid":
            s_out = _stream(self._ssm(lp["ssm"], h, lc, rows, decode,
                                      token_mask))
            x = x + 0.5 * (rmsnorm(a_out, lp["ln_attn_out"], cfg.norm_eps)
                           + rmsnorm(s_out, lp["ln_ssm_out"], cfg.norm_eps))
        else:
            x = x + a_out
        h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        if kind == "moe":
            m_out, a = moe_block(lp["moe"], cfg, h2, exact=self.exact_moe)
            return x + _stream(m_out), aux + a
        return x + _stream(swiglu(h2, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                                  lp["mlp"]["w_down"])), aux

    def _run_stack(self, kind: str, stacked: Dict, first: int, x,
                   positions, kv_pos, idx, stack_cache: Optional[Dict],
                   rows, aux, decode):
        """The stacked layers in order (``first``: the model index of the
        first, for its window), each writing its cache in place; with no
        cache (training) each layer is recomputed in the backward pass
        when ``remat``."""
        for i, lp in enumerate(unstack_layers(stacked)):
            lc = None if stack_cache is None else {
                k: a[i] for k, a in stack_cache.items()}
            args = (kind, lp, x, positions, kv_pos, idx,
                    lc, self.layer_window(first + i), rows, aux, decode)
            if lc is None and self.remat:
                x, aux = checkpoint(self._layer, *args, use_reentrant=False)
            else:
                x, aux = self._layer(*args)
        return x, aux

    def forward(self, params: Dict, inputs: torch.Tensor,
                cache: Optional[Dict], cache_len: Optional[torch.Tensor], *,
                positions: Optional[torch.Tensor] = None,
                kv_positions: Optional[torch.Tensor] = None,
                decode: bool = False, train: bool = False,
                rows: Optional[torch.Tensor] = None):
        """Serving forward over the slot cache, written in place, or the
        training forward.

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

        ``train=True`` takes no cache (``cache`` and ``cache_len`` are
        ignored): positions default to ``arange(S)``, each token attends
        over the sequence's own keys, SSM layers start from zero state,
        and the returned cache is ``None``.
        """
        cfg = self.cfg
        x = maybe_shard(self.embed_inputs(params, inputs), "batch", "seq",
                        None)
        if train:
            if positions is None:
                positions = torch.arange(
                    x.shape[1], dtype=torch.int32,
                    device=x.device)[None].expand(x.shape[0], -1)
            kv_pos, idx, stack, dense = positions, None, None, None
        else:
            positions, kv_pos, idx = cache_positions(
                cache, cache_len, x.shape[1], positions, kv_positions, rows)
            stack, dense = cache["stack"], cache.get("dense")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.n_dense:
            x, aux = self._run_stack("dense_mlp", params["dense_layers"], 0,
                                     x, positions, kv_pos, idx, dense, rows,
                                     aux, decode)
        x, aux = self._run_stack(self._stack_kind(), params["layers"],
                                 self.n_dense, x, positions, kv_pos, idx,
                                 stack, rows, aux, decode)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        logits = maybe_shard(linear(x, head), "batch", "seq", "vocab")
        return logits, (None if train else cache), aux

    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Next-token NLL (fp32 log-softmax) of the training forward,
        averaged over the batch's tokens; MoE models add ``0.01 * aux /
        max(n_stack, 1)``. Under a process mesh (``sharding.set_rules``)
        the batch is this rank's block of the data axis and the mean is
        the global one. batch: ``{'tokens': [B, S+1]}`` or
        ``{'embeddings': [B, S, d], 'labels': [B, S]}``."""
        if "embeddings" in batch:
            inputs, labels = batch["embeddings"], batch["labels"]
        else:
            inputs, labels = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
        logits, _, aux = self.forward(params, inputs, None, None, train=True)
        if get_mesh() is None or isinstance(logits, DTensor):
            loss = token_nll(logits, labels)
        else:
            # this rank's rows of the global mean: the sums and the token
            # counts of the data axis's blocks
            data = axis_group(get_mesh(), (get_rules() or {}).get("batch"))
            loss = -reduce_from_group(_label_logp(logits, labels).sum(),
                                      data) \
                / sum(block_sizes(labels.numel(), data))
        if self.cfg.is_moe:
            loss = loss + 0.01 * aux / max(self.n_stack, 1)
        return loss


def _stream(out: torch.Tensor) -> torch.Tensor:
    """A block's output laid out as the residual stream (rows over the
    batch axes, whole over the model axis), so a row-parallel product's
    partial sums are all-reduced before the residual add, as GSPMD does;
    a plain tensor passes through."""
    return maybe_shard(out, "batch", "seq", None)


def _label_logp(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Log-likelihood ``[B, S]`` of ``labels`` under ``logits [B, S,
    V]``, from an fp32 log-softmax."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(-1, labels.long()[..., None])[..., 0]


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels [B, S]`` under ``logits
    [B, S, V]``, from an fp32 log-softmax."""
    return -_label_logp(logits, labels).mean()
