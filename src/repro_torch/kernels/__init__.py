"""Attention kernels of the real execution path, written for Hopper.

``ops.chunked_prefill_attention(q, k, v, q_pos, kv_pos, *, window=0,
scale=None, use_kernels=None)``
    Attention of a prefill chunk ``q [B, C, H, D]`` over a gathered KV
    window ``k``/``v [B, S, Kv, D]`` (for the paged executor: the request's
    block table gathered flat, ``S = n_pages * page_size``). A kv token
    attends iff ``0 <= kv_pos <= q_pos`` (and ``q_pos - kv_pos < window``
    when ``window > 0``); ``-1`` marks padding.

``ops.paged_decode_attention(q, k_pages, v_pages, block_tables,
context_lens, *, use_kernels=None)``
    One decode step ``q [B, H, D]`` over the physical pool
    ``[num_pages, page_size, Kv, D]``: position ``p`` of row ``b``'s table
    is attended iff ``p < context_lens[b]``. No sliding window.

Each is a CUDA C++ kernel for ``sm_90a`` (``csrc/``), built with ``nvcc``
at first use (:mod:`repro_torch.kernels.build`) and launched through a
wrapper that counts its launches
(:mod:`~repro_torch.kernels.paged_attention`,
:mod:`~repro_torch.kernels.chunked_prefill_attention`). The plain PyTorch
versions in :mod:`~repro_torch.kernels.ref` serve CPU tensors, and CUDA
tensors only when ``use_kernels=False`` is passed.

Nothing here builds a kernel at import time. The package does not
re-export the ``ops`` functions: their names are those of the wrapper
modules, whose launch counters a caller reads.
"""
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (chunked_prefill_attention_ref,
                                     paged_decode_attention_ref)

__all__ = ["ops", "chunked_prefill_attention_ref",
           "paged_decode_attention_ref"]
