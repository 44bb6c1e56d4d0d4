"""Encoder-decoder backbone (Whisper-style). The conv/mel frontend is a
stub: the encoder takes precomputed frame embeddings ``[B, S_enc, d]``.

The counterpart of the JAX package's ``models/encdec.py``. Decoder
layers: self-attention (cached, causal) -> cross-attention over the
encoder output -> MLP. The cross-attention K/V are computed once from the
encoder output and held in the cache (``cross_k``/``cross_v``), so a
partially disaggregated prefill ships cross-KV beside the self-KV prefix.
As in :mod:`repro_torch.models.transformer`, the layers run in a Python
loop and the cache is written in place at the batch's rows; training
runs both stacks without a cache (``train=True``, ``loss``), each layer
recomputed in the backward pass when ``remat``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.attention import attention_shapes
from repro_torch.models.layers import (embed, linear, mlp_shapes, rmsnorm,
                                       swiglu)
from repro_torch.models.sharding import maybe_shard
from repro_torch.models.transformer import (_ParamTree, _stream,
                                            cache_positions, check_device,
                                            draw_params, model_dtype,
                                            token_nll, unstack_layers)


def param_shapes(cfg) -> Dict:
    """Nested dict of the parameter shapes, as the JAX
    ``EncDecModel.init_params`` lays them out: the head is never tied."""
    d, v, f = cfg.d_model, cfg.vocab_size, cfg.d_ff
    ne, nd = cfg.n_enc_layers, cfg.n_layers
    return {
        "embed": (v, d), "head": (d, v), "enc_final_norm": (d,),
        "final_norm": (d,),
        "enc_layers": {"ln1": (ne, d), "attn": attention_shapes(cfg, ne),
                       "ln2": (ne, d), "mlp": mlp_shapes(d, f, ne)},
        "layers": {"ln1": (nd, d), "attn": attention_shapes(cfg, nd),
                   "ln_cross": (nd, d), "cross": attention_shapes(cfg, nd),
                   "ln2": (nd, d), "mlp": mlp_shapes(d, f, nd)},
    }


class EncDecModel(nn.Module):
    """Encoder-decoder: ``encode``, ``compute_cross_kv``, the
    slot-cache serving ``forward``, the training forward and ``loss``.
    ``params``, ``device``, ``generator``, ``remat`` and
    ``window_override`` (the decoder's self-attention window) as for
    :class:`~repro_torch.models.transformer.DecoderModel`."""

    def __init__(self, cfg, params: Optional[Dict] = None, *,
                 device, generator: Optional[torch.Generator] = None,
                 remat: bool = True, window_override: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.window_override = window_override
        self.dtype = model_dtype(cfg)
        if params is None:
            if generator is None:
                raise ValueError("EncDecModel needs params or a generator")
            params = draw_params(param_shapes(cfg), self.dtype,
                                 generator=generator, device=device)
        else:
            check_device(params, device)
        self.tree = _ParamTree(params)

    @property
    def params(self) -> Dict:
        """Nested dict view of the parameters (the JAX pytree's layout)."""
        return self.tree.as_dict()

    def init_cache(self, batch: int, s_kv: int,
                   s_enc: Optional[int] = None) -> Dict:
        """Zeroed slot cache: ``pos [batch, s_kv]`` (-1 = empty), the
        decoder's self-attention ``k``/``v [L, batch, s_kv, Kv, D]`` under
        ``stack``, and ``cross_k``/``cross_v [L, batch, s_enc, Kv, D]``
        (``s_enc`` defaults to ``enc_seq_len``)."""
        cfg = self.cfg
        s_enc = s_enc or cfg.enc_seq_len
        dev = self.tree.embed.device
        kvh, hd, nl = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers

        def zeros(s):
            return torch.zeros((nl, batch, s, kvh, hd), dtype=self.dtype,
                               device=dev)
        return {"pos": torch.full((batch, s_kv), -1, dtype=torch.int32,
                                  device=dev),
                "stack": {"k": zeros(s_kv), "v": zeros(s_kv)},
                "cross_k": zeros(s_enc), "cross_v": zeros(s_enc)}

    def layer_window(self, i: int) -> int:
        """Decoder layer ``i``'s self-attention window (0 = full)."""
        if self.window_override is not None:
            return self.window_override
        return self.cfg.layer_window(i)

    def _run(self, layer, train: bool, *args):
        """``layer(*args)``, recomputed in the backward pass when
        training with ``remat``."""
        if train and self.remat:
            return checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)

    def _enc_layer(self, lp: Dict, x, positions):
        cfg = self.cfg
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        x = x + _stream(attn.encoder_attention(lp["attn"], cfg, h,
                                               positions))
        h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        return x + _stream(swiglu(h2, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                                  lp["mlp"]["w_down"]))

    def encode(self, params: Dict, enc_emb: torch.Tensor,
               train: bool = False) -> torch.Tensor:
        """enc_emb ``[B, S_enc, d]`` (the frontend stub's output) ->
        the encoder output ``[B, S_enc, d]`` in the model's dtype
        (``train``: each layer recomputed in the backward pass when
        ``remat``)."""
        cfg = self.cfg
        x = enc_emb.to(self.dtype)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        for lp in unstack_layers(params["enc_layers"]):
            x = self._run(self._enc_layer, train, lp, x, positions)
        return rmsnorm(x, params["enc_final_norm"], cfg.norm_eps)

    def compute_cross_kv(self, params: Dict, enc_out: torch.Tensor):
        """Every decoder layer's cross K/V ``[L, B, S_enc, Kv, D]`` from
        the encoder output."""
        cfg = self.cfg
        b, s, _ = enc_out.shape
        shape = (-1, b, s, cfg.n_kv_heads, cfg.head_dim)
        cross = params["layers"]["cross"]
        ck = torch.einsum("bsd,lde->lbse", enc_out,
                          cross["wk"].to(enc_out.dtype)).reshape(shape)
        cv = torch.einsum("bsd,lde->lbse", enc_out,
                          cross["wv"].to(enc_out.dtype)).reshape(shape)
        return ck, cv

    def _dec_layer(self, lp: Dict, x, positions, kv_pos, idx, lc, width,
                   rows, ck, cv):
        """One decoder layer: self-attention (over the cache ``lc``, or
        the sequence alone when it is ``None``), cross-attention over
        ``ck``/``cv``, MLP."""
        cfg = self.cfg
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a_out, _ = attn.attention_block(lp["attn"], cfg, h, positions,
                                        kv_pos, idx, lc, width, rows)
        x = x + _stream(a_out)
        hc = rmsnorm(x, lp["ln_cross"], cfg.norm_eps)
        x = x + _stream(attn.cross_attention(lp["cross"], cfg, hc, ck, cv))
        h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        return x + _stream(swiglu(h2, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                                  lp["mlp"]["w_down"]))

    def forward(self, params: Dict, inputs: torch.Tensor,
                cache: Optional[Dict], cache_len: Optional[torch.Tensor], *,
                positions: Optional[torch.Tensor] = None,
                kv_positions: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None,
                decode: bool = False, train: bool = False,
                rows: Optional[torch.Tensor] = None):
        """Decoder serving forward over the slot cache, written in place;
        arguments as :meth:`DecoderModel.forward` (``decode`` changes
        nothing here). With ``enc_out`` (a first prefill chunk) the
        cross-KV is computed from it and written to the batch's rows of
        the cache, whose encoder length it must have; otherwise it is read
        from those rows. Returns ``(logits [b, S, V], cache, 0.0)``.

        ``train=True`` takes no cache and needs ``enc_out``: the cross-KV
        comes from it, positions default to ``arange(S)``, self-attention
        sees the sequence alone, and the returned cache is ``None``."""
        cfg = self.cfg
        x = maybe_shard(embed(params["embed"].to(self.dtype), inputs),
                        "batch", "seq", None)
        b = x.shape[0]
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if train:
            if enc_out is None:
                raise ValueError("the training forward needs enc_out")
            if positions is None:
                positions = torch.arange(
                    x.shape[1], dtype=torch.int32,
                    device=x.device)[None].expand(b, -1)
            for i, lp in enumerate(unstack_layers(params["layers"])):
                ck, cv = attn.cross_kv(lp["cross"], cfg, enc_out)
                x = self._run(self._dec_layer, True, lp, x, positions,
                              positions, None, None, self.layer_window(i),
                              None, ck, cv)
            return self._logits(params, x), None, zero
        positions, kv_pos, idx = cache_positions(
            cache, cache_len, x.shape[1], positions, kv_positions, rows)
        sel = torch.arange(b, device=x.device) if rows is None else rows
        cross = None
        if enc_out is not None:
            if enc_out.shape[1] != cache["cross_k"].shape[2]:
                raise ValueError(
                    f"encoder output of {enc_out.shape[1]} frames for a "
                    f"cross-KV cache of {cache['cross_k'].shape[2]}")
            cross = self.compute_cross_kv(params, enc_out)
            for k, a in zip(("cross_k", "cross_v"), cross):
                cache[k].index_copy_(1, sel, a.to(cache[k].dtype))
        for i, lp in enumerate(unstack_layers(params["layers"])):
            lc = {k: a[i] for k, a in cache["stack"].items()}
            if cross is None and rows is None:
                ck, cv = (cache[k][i][:b] for k in ("cross_k", "cross_v"))
            elif cross is None:
                ck, cv = (cache[k][i].index_select(0, rows)
                          for k in ("cross_k", "cross_v"))
            else:
                ck, cv = cross[0][i], cross[1][i]
            x = self._dec_layer(lp, x, positions, kv_pos, idx, lc,
                                self.layer_window(i), rows, ck, cv)
        return self._logits(params, x), cache, zero

    def _logits(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        return maybe_shard(linear(x, params["head"]), "batch", "seq",
                           "vocab")

    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Next-token NLL (fp32 log-softmax) of the training forward.
        batch: ``{'enc_emb': [B, S_enc, d], 'tokens': [B, S+1]}``."""
        enc_out = self.encode(params, batch["enc_emb"], train=True)
        tokens = batch["tokens"]
        logits, _, _ = self.forward(params, tokens[:, :-1], None, None,
                                    enc_out=enc_out, train=True)
        return token_nll(logits, tokens[:, 1:])
