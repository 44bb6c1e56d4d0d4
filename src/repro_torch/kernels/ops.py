"""Dispatching wrappers over the attention kernels.

``use_kernels=None`` (the default) or ``True`` goes to the kernel wrapper,
which launches the CUDA kernel for CUDA tensors and computes the plain
version for CPU tensors. ``use_kernels=False`` computes the plain version
on any device; on CUDA this happens only when a caller asks for it (the
on-card parity check does).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import chunked_prefill_attention as _prefill
from repro_torch.kernels import paged_attention as _decode
from repro_torch.kernels import ref


def chunked_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, q_pos: torch.Tensor,
                              kv_pos: torch.Tensor, *, window: int = 0,
                              scale: Optional[float] = None,
                              use_kernels: Optional[bool] = None
                              ) -> torch.Tensor:
    """Chunked-prefill attention; see
    :func:`repro_torch.kernels.chunked_prefill_attention.chunked_prefill_attention`."""
    if use_kernels is False:
        return ref.chunked_prefill_attention_ref(q, k, v, q_pos, kv_pos,
                                                 window, scale)
    return _prefill.chunked_prefill_attention(q, k, v, q_pos, kv_pos,
                                              window=window, scale=scale)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           context_lens: torch.Tensor, *,
                           use_kernels: Optional[bool] = None
                           ) -> torch.Tensor:
    """Paged decode attention; see
    :func:`repro_torch.kernels.paged_attention.paged_decode_attention`."""
    if use_kernels is False:
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              block_tables, context_lens)
    return _decode.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                          context_lens)
