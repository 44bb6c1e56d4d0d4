"""Serving API of the port: the real-compute executor factory.

``paged_executor_factory`` is the counterpart of the paged branch of the
JAX package's ``ServeSpec._executor_factory``: it returns a
``factory(role)`` that the builders in :mod:`repro_torch.serving.simulator`
call once per engine. ``ServeSpec``/``InferenceService`` are still to be
ported.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core.executor import PagedRealExecutor
from repro_torch.models.transformer import DecoderModel, check_device


def paged_executor_factory(cfg, model: Optional[DecoderModel] = None,
                           params: Optional[Dict] = None, *,
                           device="cuda", use_kernels: Optional[bool] = None,
                           seed: int = 0) -> Callable:
    """``factory(role) -> PagedRealExecutor``: one executor (and block
    pool) per engine, all sharing one copy of the weights.

    Without ``model`` and ``params``, the weights are drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed``. ``device`` defaults to
    the card: with no CUDA device this raises ``RuntimeError`` rather than
    carry on on the CPU; pass ``device="cpu"`` for the plain versions. A
    ``model`` or ``params`` that lies elsewhere than ``device`` raises
    ``ValueError``. ``use_kernels`` is handed to every executor (``None``:
    the CUDA kernels on the card, the plain versions on the CPU).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("paged_executor_factory: no CUDA device "
                           "(pass device='cpu' to run on the CPU)")
    if model is None:
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            model = DecoderModel(cfg, device=device, generator=gen)
        else:
            model = DecoderModel(cfg, params, device=device)
    check_device(model.params, device, "model.params")
    if params is None:
        params = model.params
    check_device(params, device)

    def factory(role: str) -> PagedRealExecutor:
        """Fresh paged executor per engine (own block pool)."""
        return PagedRealExecutor(model, params, use_kernels=use_kernels)
    return factory
