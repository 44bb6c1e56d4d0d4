"""Chunked-prefill attention: the CUDA kernel's wrapper.

Replaces the JAX package's Pallas TPU kernel
``kernels/chunked_prefill_attention.py::chunked_prefill_attention_pallas``;
the kernel itself is ``csrc/chunked_prefill_attention.cu``. On a CUDA
tensor the wrapper launches the kernel or raises; on a CPU tensor it
computes the plain version
(:func:`repro_torch.kernels.ref.chunked_prefill_attention_ref`), because
the kernel has no CPU mode. The kernel masks ragged C and S edges itself,
so nothing is padded here. bf16 runs on the tensor cores; fp32 (parity
checks) on the CUDA cores.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref

# kernel launches since the last reset (the caller may set it to 0)
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load(
        "chunked_prefill_attention.cu").chunked_prefill_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i,
                   p]
    fn.restype = i
    return fn


def _check(q, k, v, q_pos, kv_pos, window):
    tensors = (q, k, v, q_pos, kv_pos)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"chunked_prefill_attention: q/k/v must share a "
                        f"dtype of {list(DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise TypeError("chunked_prefill_attention: positions must be int32")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("chunked_prefill_attention: q [B,C,H,D], "
                         "k/v [B,S,Kv,D]")
    b, c, h, d = q.shape
    _, s, kvh, dk = k.shape
    if v.shape != k.shape or k.shape[0] != b or dk != d or h % kvh \
            or h // kvh > 64 or d not in HEAD_DIMS \
            or q_pos.shape != (b, c) or kv_pos.shape != (b, s) \
            or window < 0:
        raise ValueError(
            f"chunked_prefill_attention: unsupported shapes q "
            f"{tuple(q.shape)}, k/v {tuple(k.shape)}/{tuple(v.shape)}, "
            f"q_pos {tuple(q_pos.shape)}, kv_pos {tuple(kv_pos.shape)}, "
            f"window {window} (D in {HEAD_DIMS}, H % Kv == 0, H / Kv <= 64)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("chunked_prefill_attention: inputs must be "
                         "contiguous")
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("chunked_prefill_attention: all inputs must lie on "
                         "one CUDA device")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("chunked_prefill_attention: q/k/v must be 16-byte "
                         "aligned (the kernel copies 16-byte chunks)")


def chunked_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, q_pos: torch.Tensor,
                              kv_pos: torch.Tensor, *, window: int = 0,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Attention of a prefill chunk over its gathered KV context.

    q [B,C,H,D]; k/v [B,S,Kv,D]; q_pos [B,C] and kv_pos [B,S] int32 with
    -1 for padding -> [B,C,H,D]. A pair attends iff ``0 <= kv_pos <=
    q_pos`` (and ``kv_pos > q_pos - window`` when ``window > 0``); a row
    with no valid key gives zeros. ``scale`` defaults to ``D ** -0.5``.
    """
    global launches
    if q.device.type == "cpu":
        return ref.chunked_prefill_attention_ref(q, k, v, q_pos, kv_pos,
                                                 window, scale)
    _check(q, k, v, q_pos, kv_pos, window)
    b, c, h, d = q.shape
    _, s, kvh, _ = k.shape
    out = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                kv_pos.data_ptr(), out.data_ptr(), b, c, s, h, kvh, d,
                int(window), d ** -0.5 if scale is None else float(scale),
                DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"chunked_prefill_attention kernel: CUDA error {err}")
    launches += 1
    return out
