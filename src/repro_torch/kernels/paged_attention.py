"""Paged decode attention: the CUDA kernel's wrapper.

Replaces the JAX package's Pallas TPU kernel
``kernels/paged_attention.py::paged_decode_attention_pallas``; the kernel
itself is ``csrc/paged_attention.cu``. On a CUDA tensor the wrapper
launches the kernel or raises; on a CPU tensor it computes the plain
version (:func:`repro_torch.kernels.ref.paged_decode_attention_ref`),
because the kernel has no CPU mode.

The kernel splits each context into runs of ``split_tokens()`` positions
(one block each) and merges the splits in a second launch; the wrapper
sizes the grid from the table width, never from ``context_lens``, and
allocates the fp32 scratch of the per-split partials.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

# kernel launches since the last reset (the caller may set it to 0)
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("paged_attention.cu").paged_decode_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                   ctypes.c_float, i, p]
    fn.restype = i
    return fn


@functools.lru_cache(maxsize=None)
def split_tokens() -> int:
    """Context positions per split of the kernel (builds it if needed)."""
    return build.load("paged_attention.cu").paged_decode_split_tokens()


def _check(q, k_pages, v_pages, block_tables, context_lens):
    tensors = (q, k_pages, v_pages, block_tables, context_lens)
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention: q/k/v must share a dtype "
                        f"of {list(DTYPES)}, got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tables and "
                        "context_lens must be int32")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("paged_decode_attention: q [B,H,D], "
                         "k/v_pages [P,page,Kv,D]")
    b, h, d = q.shape
    _, page, kvh, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d or h % kvh \
            or h // kvh > 64 or d not in HEAD_DIMS \
            or block_tables.dim() != 2 or block_tables.shape[0] != b \
            or context_lens.shape != (b,) or page < 1:
        raise ValueError(
            f"paged_decode_attention: unsupported shapes q {tuple(q.shape)}, "
            f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)}, tables "
            f"{tuple(block_tables.shape)}, lens {tuple(context_lens.shape)} "
            f"(D in {HEAD_DIMS}, H % Kv == 0, H / Kv <= 64)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention: inputs must be contiguous")
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("paged_decode_attention: all inputs must lie on "
                         "one CUDA device")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode_attention: the K/V pools must be "
                         "16-byte aligned (the kernel loads 16-byte vectors)")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           context_lens: torch.Tensor) -> torch.Tensor:
    """One decode step over the block pool (two kernel launches, counted
    as one launch of the op).

    q [B,H,D]; k/v_pages [P,page,Kv,D]; block_tables [B,max_pages] int32
    (entries past ``ceil(context_lens[b] / page)`` are never read);
    context_lens [B] int32 -> [B,H,D]. A row with ``context_lens == 0``
    gives zeros; a context past ``max_pages * page`` counts as the table's
    full width, as in the plain version. The tables must hold row ids of
    the pool: the kernel does not bound-check them.
    """
    global launches
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              block_tables, context_lens)
    _check(q, k_pages, v_pages, block_tables, context_lens)
    b, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    n_splits = max(1, -(-max_pages * page // split_tokens()))
    out = torch.empty_like(q)
    part_ml = torch.empty((b, kvh, n_splits, h // kvh, 2),
                          dtype=torch.float32, device=q.device)
    part_acc = torch.empty((b, kvh, n_splits, h // kvh, d),
                           dtype=torch.float32, device=q.device)
    err = _fn()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), context_lens.data_ptr(),
                out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(), b, h,
                kvh, d, page, max_pages, n_splits, d ** -0.5,
                DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode_attention kernel: CUDA error {err}")
    launches += 1
    return out
