"""Abstract input specs per (architecture x input shape) for the dry-run:
meta tensors with the JAX package's shapes and dtypes, and beside them a
tree of partition specs (:class:`~repro_torch.models.sharding.P`) over a
logical mesh. Nothing is allocated.

Sharding policy (as the JAX package's):
  * batch        -> ('pod','data') / ('data',)
  * attention KV -> kv-heads on 'model' when divisible, else the cache
                    *sequence* on 'model'
  * long_500k    -> batch=1: KV sequence sharded over data x model;
                    SWA-variant archs use a ring cache of window size
  * experts      -> 'model' (expert parallel)

Dtypes are the JAX package's throughout: serving weights in bf16 where
they are fp32 and at least 2-D, token ids, ``cache_len`` and
``kv_positions`` int32, a VLM's prefill embeddings bf16; training keeps
fp32 weights and AdamW moments. The port's embedding takes int32 ids as
they are (it widens them itself), so no dtype differs.

Not ported: the JAX package's ``REPRO_HD_SHARDED_DECODE`` experiment
(head-dim-sharded decode caches with scatter writes, refuted there), and
``scan_unroll`` (eager PyTorch runs its layers in a Python loop; there is
no scan to unroll).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import batch_axes, sharding_rules
from repro_torch.models.api import build_model, param_shapes
from repro_torch.models.sharding import (P, divisible_spec,
                                         params_sharding_tree)
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import make_train_step

WHISPER_TRAIN_ENC_LEN = 1500

META = torch.device("meta")


@dataclasses.dataclass
class Specs:
    """A step's arguments as meta tensors (``args``, a tuple of trees) and
    each leaf's partition spec in a parallel tuple of trees (``pspecs``)."""
    args: Tuple
    pspecs: Tuple


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _map(fn: Callable, tree: Dict) -> Dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def abstract_params(cfg: ModelConfig, serving: bool) -> Dict:
    """The parameter tree as meta tensors in the JAX package's dtypes:
    fp32 as initialised, and for serving each fp32 leaf of rank >= 2 in
    bf16 (the deployment's weights)."""
    def leaf(shape):
        dtype = (torch.bfloat16 if serving and len(shape) >= 2
                 else torch.float32)
        return _meta(shape, dtype)
    return _map(leaf, param_shapes(cfg))


def window_override_for(cfg: ModelConfig, shape: InputShape
                        ) -> Optional[int]:
    """long_500k on full-attention archs uses the sliding-window variant."""
    if shape.name == "long_500k" and cfg.swa_variant_window \
            and not cfg.window_size:
        return cfg.swa_variant_window
    return None


def build_dryrun_model(cfg: ModelConfig, shape: InputShape, params: Dict):
    """The model of ``cfg`` on the meta device around ``params`` (meta
    tensors), with its window override for ``shape``; returns ``(model,
    window_override)``."""
    window_override = window_override_for(cfg, shape)
    return build_model(cfg, params, device=META,
                       window_override=window_override), window_override


def cache_seq_len(cfg: ModelConfig, shape: InputShape,
                  window_override) -> int:
    if cfg.arch_type == "ssm":
        return 1
    if window_override:
        # ring cache: window + chunk (decode chunk = 1). Must hold the full
        # window *plus* the tokens being written, or the write evicts
        # entries the chunk's own queries still need.
        return window_override + 1
    return shape.seq_len


def cache_pspec(name: str, shape: Tuple[int, ...], cfg: ModelConfig, mesh,
                global_batch: int, s_kv: int, multi_pod: bool) -> P:
    """The partition spec of one cache leaf, from its name (the last key
    of its path) and shape, made divisible over ``mesh``."""
    b_ax = batch_axes(multi_pod) if global_batch > 1 else None
    n_dev_model = mesh.shape["model"]
    kv_on_model = (cfg.n_kv_heads % n_dev_model == 0) \
        and not cfg.mla_kv_lora_rank
    # decode with batch=1: shard sequence as much as possible
    if global_batch == 1 and s_kv > 4096:
        seq_ax: object = ("data", "model")
        kv_on_model = False
    else:
        seq_ax = "model" if not kv_on_model else None

    if name == "pos":
        spec = P(b_ax, seq_ax if not kv_on_model else None)
    elif name in ("k", "v"):                     # [L,B,S,kv,hd]
        spec = P(None, b_ax, seq_ax, "model" if kv_on_model else None, None)
    elif name in ("ckv", "kpe"):                 # [L,B,S,r]
        spec = P(None, b_ax, seq_ax, None)
    elif name == "h":                            # [L,B,H,P,N]
        d_model_ok = shape[2] % n_dev_model == 0
        spec = P(None, b_ax, "model" if d_model_ok else None, None, None)
    elif name == "conv":                         # [L,B,W-1,C]
        ok = shape[3] % n_dev_model == 0
        spec = P(None, b_ax, None, "model" if ok else None)
    elif name in ("cross_k", "cross_v"):         # [L,B,S_enc,kv,hd]
        spec = P(None, b_ax, None, "model" if kv_on_model else None, None)
    else:
        spec = P(*([None] * len(shape)))
    return divisible_spec(spec, shape, mesh)


def _cache_pspecs(tree: Dict, cfg, mesh, shape: InputShape, s_kv: int,
                  multi_pod: bool) -> Dict:
    out = {}
    for k, v in tree.items():
        out[k] = (_cache_pspecs(v, cfg, mesh, shape, s_kv, multi_pod)
                  if isinstance(v, dict) else
                  cache_pspec(k, tuple(v.shape), cfg, mesh,
                              shape.global_batch, s_kv, multi_pod))
    return out


def make_serve_specs(cfg: ModelConfig, shape: InputShape, mesh, *,
                     multi_pod: bool):
    """Returns ``(step, specs)`` for prefill/decode shapes: ``step(params,
    cache, tokens, cache_len, kv_positions) -> (logits, cache)`` runs the
    port's serving forward (the cache written in place) and ``specs`` are
    its arguments (:class:`Specs`)."""
    assert shape.kind in ("prefill", "decode")
    params = abstract_params(cfg, serving=True)
    model, window_override = build_dryrun_model(cfg, shape, params)
    rules = sharding_rules(multi_pod, cfg)
    seq_in_ax = rules.get("seq") if shape.kind == "prefill" else None
    b = shape.global_batch
    b_ax = batch_axes(multi_pod) if b > 1 else None
    s_q = 1 if shape.kind == "decode" else shape.seq_len
    s_kv = cache_seq_len(cfg, shape, window_override)

    p_spec = params_sharding_tree(params, mesh, rules)
    cache = model.init_cache(b, s_kv)
    cache_spec = _cache_pspecs(cache, cfg, mesh, shape, s_kv, multi_pod)

    # enc-dec (whisper): the *encoder* consumes stub embeddings; the decoder
    # (what prefill/decode shapes run) takes token ids. Only decoder-only
    # embedding-input archs (VLM) feed embeddings at prefill.
    if cfg.embeddings_input and not cfg.enc_dec and shape.kind == "prefill":
        tokens = _meta((b, s_q, cfg.d_model), torch.bfloat16)
        tok_spec = P(b_ax, seq_in_ax, None)
    else:
        tokens = _meta((b, s_q), torch.int32)
        tok_spec = P(b_ax, seq_in_ax)
    cache_len = _meta((b,), torch.int32)
    # kv_positions aligned with cache['pos'] sharding
    kv_positions = _meta((b, max(s_kv, 1)), torch.int32)

    decode = shape.kind == "decode"

    @torch.no_grad()
    def step(params, cache, tokens, cache_len, kv_positions):
        logits, new_cache, _ = model.forward(
            params, tokens, cache, cache_len, kv_positions=kv_positions,
            decode=decode)
        return logits, new_cache

    return step, Specs(
        args=(params, cache, tokens, cache_len, kv_positions),
        pspecs=(p_spec, cache_spec, tok_spec, P(None), cache_spec["pos"]))


def make_train_specs(cfg: ModelConfig, shape: InputShape, mesh, *,
                     multi_pod: bool):
    """Returns ``(step, specs)`` for a train shape: ``step(params,
    opt_state, batch) -> (params, opt_state, loss)`` takes the loss's
    gradient and one AdamW step (:func:`make_train_step`)."""
    assert shape.kind == "train"
    params = abstract_params(cfg, serving=False)
    model = build_model(cfg, params, device=META, remat=True)
    rules = sharding_rules(multi_pod, cfg)
    b = shape.global_batch
    b_ax = batch_axes(multi_pod)

    p_spec = params_sharding_tree(params, mesh, rules)
    opt = {"step": _meta((), torch.int32),
           "m": _map(lambda t: torch.empty_like(t, dtype=torch.float32),
                     params),
           "v": _map(lambda t: torch.empty_like(t, dtype=torch.float32),
                     params)}
    opt_spec = {"step": P(), "m": p_spec, "v": p_spec}

    batch = {"tokens": _meta((b, shape.seq_len + 1), torch.int32)}
    batch_spec = {"tokens": P(b_ax, None)}
    if cfg.enc_dec:
        batch["enc_emb"] = _meta((b, WHISPER_TRAIN_ENC_LEN, cfg.d_model),
                                 torch.bfloat16)
        batch_spec["enc_emb"] = P(b_ax, None, None)

    train_step = make_train_step(model, AdamWConfig())

    def step(params, opt_state, batch):
        params, opt_state, stats = train_step(params, opt_state, batch)
        return params, opt_state, stats["loss"]

    return step, Specs(args=(params, opt, batch),
                       pspecs=(p_spec, opt_spec, batch_spec))


def make_specs(cfg: ModelConfig, shape: InputShape, mesh, *,
               multi_pod: bool):
    """:func:`make_train_specs` or :func:`make_serve_specs` by the
    shape's kind."""
    fn = make_train_specs if shape.kind == "train" else make_serve_specs
    return fn(cfg, shape, mesh, multi_pod=multi_pod)


def leaves(tree) -> Dict[str, object]:
    """``{'a/b': leaf}`` over nested dicts and tuples (tuple positions as
    keys), dict keys in sorted order as ``jax.tree_util`` walks them."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple) and not isinstance(tree, P):
        items = enumerate(tree)
    else:
        return {"": tree}
    out = {}
    for k, v in items:
        for path, leaf in leaves(v).items():
            out[f"{k}/{path}" if path else str(k)] = leaf
    return out
