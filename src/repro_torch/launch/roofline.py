"""Roofline terms of the dry-run in H100 units.

Terms, per device of an evenly partitioned step:
  compute = FLOPs / 989 TFLOP/s (bf16 dense)
  memory  = bytes / 3.35 TB/s   (HBM)

The counts come from the port's own step run on ``device="meta"``, which
allocates nothing: FLOPs from ``torch.utils.flop_counter.FlopCounterMode``
(the matrix products: ``mm``, ``bmm``, ``addmm``, ...; elementwise work is
not counted), bytes from :class:`ByteCounter`, the eager counterpart of
XLA's "bytes accessed": eager PyTorch fuses nothing, so it is the traffic
the port's step issues, op by op. Per-device counts are the global count
over the number of cards.

The JAX package reads its counts from the SPMD-partitioned module that XLA
compiled, with collectives placed by the partitioner. The port has no
partitioner: the collective term, the collective byte and op counts, and
XLA's temporary and generated-code sizes have no counterpart here and are
``None`` in the report; the bottleneck is taken over compute and memory.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_FLOPS = 989e12      # bf16, per card
HBM_BW = 3.35e12         # bytes/s per card

_aten = torch.ops.aten

# allocate or alias: no data moves
_NO_TRAFFIC = frozenset((
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
    _aten.empty_like.default, _aten._unsafe_view.default,
    _aten.lift_fresh.default, _aten._local_scalar_dense.default,
))
# read rows of their first operand through an index: charged the rows
# they read (the size of the output), the index, and the output
_GATHERS = frozenset((
    _aten.index.Tensor, _aten.index_select.default, _aten.gather.default,
    _aten.embedding.default,
))
# write rows of their first operand in place through an index: charged
# the values and the index read, and the rows written (read too where
# they accumulate)
_INDEX_PUTS = frozenset((_aten.index_put_.default,
                         _aten._index_put_impl_.default))
_SCATTERS = {
    _aten.index_copy_.default: False, _aten.index_add_.default: True,
    _aten.scatter_.src: False, _aten.scatter_.value: False,
    _aten.scatter_add_.default: True,
}
# write their result whole, reading nothing of their tensor operand
_FILLS = frozenset((_aten.fill_.Scalar, _aten.fill_.Tensor,
                    _aten.zero_.default, _aten.zeros_like.default,
                    _aten.ones_like.default, _aten.full_like.default,
                    _aten.new_zeros.default, _aten.new_ones.default,
                    _aten.new_full.default))


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor view spans (a broadcast
    dimension, stride 0, counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _index_region(self_t: torch.Tensor, indices) -> int:
    """Elements of ``self_t`` that ``self_t[indices] = ...`` writes: the
    broadcast index shape times the dimensions left unindexed."""
    idx = [i for i in indices if i is not None]
    n = torch.broadcast_shapes(*(i.shape for i in idx)).numel() if idx \
        else 1
    rest = 1
    for d, size in enumerate(self_t.shape):
        if d >= len(indices) or indices[d] is None:
            rest *= size
    return n * rest


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten op moves: each tensor operand read once and each
    result written once, views and allocations free, and indexed reads and
    writes charged only the rows they touch."""
    if func.is_view or func in _NO_TRAFFIC:
        return 0
    if func in _GATHERS:
        idx = [t for t in _tensors(args[1:]) if not t.is_floating_point()]
        return 2 * tensor_bytes(out) + sum(map(tensor_bytes, idx))
    if func in _INDEX_PUTS or func in _SCATTERS:
        self_t = args[0]
        if func in _INDEX_PUTS:
            region = _index_region(self_t, args[1])
            reads = list(_tensors(args[1])) + [args[2]]
            accumulate = (args[3] if len(args) > 3
                          else kwargs.get("accumulate", False))
        elif func in (_aten.scatter_.src, _aten.scatter_.value,
                      _aten.scatter_add_.default):
            region = args[2].numel()
            reads = list(_tensors(args[2:]))
            accumulate = _SCATTERS[func]
        else:                                  # index_copy_ / index_add_
            region = args[3].numel()
            reads = [args[2], args[3]]
            accumulate = _SCATTERS[func]
        written = region * self_t.element_size()
        return (sum(map(tensor_bytes, reads)) + written
                + (written if accumulate else 0))
    if func in _FILLS:
        return tensor_bytes(out)
    if func is _aten.copy_.default:
        return tensor_bytes(args[0]) + tensor_bytes(args[1])
    return (sum(map(tensor_bytes, _tensors((args, kwargs))))
            + sum(map(tensor_bytes, _tensors(out))))


class ByteCounter(TorchDispatchMode):
    """Sums :func:`op_bytes` over every aten op run under it (``total``)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.total += op_bytes(func, args, kwargs, out)
        return out


def roofline_report(counts: Dict, n_chips: int, model_flops_global: float,
                    mem: Dict) -> Dict:
    """The JAX package's report keys from global ``counts`` (``flops``,
    ``bytes``: ints) spread evenly over ``n_chips``, and the per-device
    ``mem`` sizes (``argument``, ``output``); the keys with no counterpart
    here are ``None``."""
    flops_dev = counts["flops"] / n_chips
    bytes_dev = counts["bytes"] / n_chips
    report = {
        "chips": n_chips,
        "flops_per_device": flops_dev,
        "flops_global": counts["flops"],
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": None,
        "collective_ops": None,
        "collective_count": None,
        "t_compute": flops_dev / PEAK_FLOPS,
        "t_memory": bytes_dev / HBM_BW,
        "t_collective": None,
        "model_flops_global": model_flops_global,
    }
    report["useful_flops_ratio"] = (
        model_flops_global / report["flops_global"]
        if report["flops_global"] else float("nan"))
    terms = {"compute": report["t_compute"], "memory": report["t_memory"]}
    report["bottleneck"] = max(terms, key=terms.get)
    report.update({
        "mem_argument_size_in_bytes": mem["argument"],
        "mem_output_size_in_bytes": mem["output"],
        "mem_temp_size_in_bytes": None,
        "mem_generated_code_size_in_bytes": None,
    })
    return report


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active·D for training, 2·N_active·D for serving,
    D = total tokens processed globally this step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # decode: one token per request
    return 2.0 * n * tokens


def count_step(step, args) -> Dict[str, int]:
    """FLOPs, bytes moved and result bytes of one call ``step(*args)``
    (global counts, ints)."""
    with FlopCounterMode(display=False) as fc, ByteCounter() as bc:
        out = step(*args)
    return {"flops": int(fc.get_total_flops()), "bytes": int(bc.total),
            "output": sum(map(tensor_bytes, _tensors(out)))}
