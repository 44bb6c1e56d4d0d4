"""Unified model construction: ``build_model(cfg)`` -> DecoderModel |
EncDecModel, and the parameter layout of either."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.transformer import DecoderModel


def param_shapes(cfg) -> Dict:
    """Nested dict of a config's parameter shapes (the JAX
    ``init_params`` layout), for a decoder or an encoder-decoder."""
    return (encdec.param_shapes(cfg) if cfg.enc_dec
            else transformer.param_shapes(cfg))


def build_model(cfg, params: Optional[Dict] = None, *, device,
                generator: Optional[torch.Generator] = None,
                exact_moe: bool = False):
    """The model of ``cfg`` on ``device``: an :class:`EncDecModel` for an
    encoder-decoder config, else a :class:`DecoderModel` (``exact_moe``:
    its MoE layers drop nothing); ``params`` or a ``generator`` to draw
    them, as their constructors take."""
    if cfg.enc_dec:
        return EncDecModel(cfg, params, device=device, generator=generator)
    return DecoderModel(cfg, params, device=device, generator=generator,
                        exact_moe=exact_moe)
