"""Roofline terms of the dry-run in H100 units.

Terms, per card of a partitioned step:
  compute    = FLOPs / 989 TFLOP/s (bf16 dense)
  memory     = bytes / 3.35 TB/s   (HBM)
  collective = collective bytes / 50 GB/s (one NDR link, ``LINK_BW``)

The counts come from the port's own step run on ``device="meta"``, which
allocates nothing, as ``DTensor``s over a ``DeviceMesh`` of the cell's
shape on a fake process group (``launch/mesh.py::fake_mesh``): DTensor's
sharding propagation places the collectives, as XLA's SPMD partitioner
does in the JAX package, and the counters below see rank 0's local ops
at one card's shapes. FLOPs come from ``torch.utils.flop_counter``'s
formulas (:class:`FlopCounter`: the matrix products ``mm``, ``bmm``,
``addmm``, ...; elementwise work is not counted), bytes from
:class:`ByteCounter`, the eager counterpart of XLA's "bytes accessed":
eager PyTorch fuses nothing, so it is the traffic the port's step issues,
op by op. :class:`CollectiveCounter` reads the collectives as JAX's
``collective_bytes`` reads them from HLO (each result's bytes per card,
by kind), and ``MemTracker``'s peak gives the temporary bytes.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_FLOPS = 989e12      # bf16, per card
HBM_BW = 3.35e12         # bytes/s per card
# bytes/s per card for collectives, one link as JAX's ICI_BW is: a
# 16-wide model axis spans two 8-card HGX nodes, so its ring crosses each
# card's 400 Gb/s NDR InfiniBand port (NVIDIA ConnectX-7 data sheet),
# not only NVLink's 450 GB/s a direction inside a node
LINK_BW = 50e9

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


def _is_fake(args, kwargs) -> bool:
    return any(isinstance(t, FakeTensor) for t in _tensors((args, kwargs)))


class _LocalOps(TorchDispatchMode):
    """Calls :meth:`_count` on every op run on plain tensors under it.
    A ``DTensor`` op is handed back to ``DTensor`` (``NotImplemented``),
    which runs it as local ops on this rank's blocks, and those come back
    through the mode; the ops ``DTensor`` runs on fake tensors to
    propagate shardings are not counted, nor, given ``device`` (the
    step's), the ops with no tensor there (DTensor works out shard sizes
    with small host tensors). So each op is counted once, at one card's
    shapes, and with no ``DTensor`` at the global shapes."""

    def __init__(self, device=None):
        super().__init__()
        self.device = None if device is None else torch.device(device)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _is_fake(args, kwargs) and (
                self.device is None or any(
                    t.device == self.device
                    for t in _tensors((args, kwargs, out)))):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        raise NotImplementedError


# the namespaces of collectives and their helpers (waits, autograd
# wrappers), which move no bytes in HBM of their own
_COMM_NAMESPACES = frozenset(("_c10d_functional", "_c10d_functional_autograd",
                              "c10d", "_dtensor"))


class ByteCounter(_LocalOps):
    """Sums :func:`op_bytes` over every op run under it (``total``);
    collectives are counted by :class:`CollectiveCounter` instead."""

    def __init__(self, device=None):
        super().__init__(device)
        self.total = 0

    def _count(self, func, args, kwargs, out) -> None:
        if func.namespace not in _COMM_NAMESPACES:
            self.total += op_bytes(func, args, kwargs, out)


class FlopCounter(_LocalOps):
    """FLOPs of the matrix products run under it (``total``), by
    ``torch.utils.flop_counter``'s formulas; an op those have no formula
    for runs as its decomposition where it has one, as
    ``FlopCounterMode`` does."""

    def __init__(self, device=None):
        super().__init__(device)
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # the test is FlopCounterMode's own (an overload against a table
        # of packets: every op is offered its decomposition)
        if (not any(issubclass(t, DTensor) for t in types)
                and func not in flop_registry
                and func is not torch.ops.prim.device.default):
            with self:
                out = func.decompose(*args, **(kwargs or {}))
            if out is not NotImplemented:
                return out
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _count(self, func, args, kwargs, out) -> None:
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)


# collectives by JAX's kind names (``repro.launch.roofline``): the
# functional collectives DTensor issues (a shard-to-shard move on a CUDA
# mesh is its own ``_dtensor`` op) and the in-place c10d ops of
# ``models/collectives.py``
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
_KIND_OF = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


def collective_kind(func):
    """JAX's kind name of a collective op, else ``None``."""
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d", "_dtensor"):
        return None
    return _KIND_OF.get(func._overloadpacket.__name__)


class CollectiveCounter(_LocalOps):
    """The collectives issued under it, as JAX's ``collective_bytes``
    reads them from HLO: per kind, the bytes of each result on this card
    (``bytes``), the number of ops (``count``) and each op in order as
    ``(kind, result bytes)`` (``ops``)."""

    def __init__(self, device=None):
        super().__init__(device)
        self.bytes = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.count = 0
        self.ops = []

    def _count(self, func, args, kwargs, out) -> None:
        kind = collective_kind(func)
        if kind is None:
            return
        # the in-place c10d ops return (tensors, work): the result is the
        # buffer they write
        res = args[0] if func.namespace == "c10d" else out
        n = sum(map(tensor_bytes, _tensors(res)))
        self.bytes[kind] += n
        self.count += 1
        self.ops.append((kind, n))


def roofline_report(counts: Dict, n_chips: int, model_flops_global: float,
                    mem: Dict) -> Dict:
    """The JAX package's report keys from one card's ``counts``
    (``flops``, ``bytes``, each of :data:`COLLECTIVE_KINDS` and
    ``coll_count``: ints) on a mesh of ``n_chips``, and the card's
    ``mem`` sizes (``argument``, ``output``, ``temp``). The bottleneck is
    the largest of the compute, memory and collective terms. Eager
    PyTorch generates no code, so ``mem_generated_code_size_in_bytes``
    is ``None``."""
    flops_dev, bytes_dev = counts["flops"], counts["bytes"]
    ops = {k: counts[k] for k in COLLECTIVE_KINDS}
    coll = sum(ops.values())
    report = {
        "chips": n_chips,
        "flops_per_device": flops_dev,
        "flops_global": flops_dev * n_chips,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll,
        "collective_ops": ops,
        "collective_count": counts["coll_count"],
        "t_compute": flops_dev / PEAK_FLOPS,
        "t_memory": bytes_dev / HBM_BW,
        "t_collective": coll / LINK_BW,
        "model_flops_global": model_flops_global,
    }
    report["useful_flops_ratio"] = (
        model_flops_global / report["flops_global"]
        if report["flops_global"] else float("nan"))
    terms = {"compute": report["t_compute"], "memory": report["t_memory"],
             "collective": report["t_collective"]}
    report["bottleneck"] = max(terms, key=terms.get)
    report.update({
        "mem_argument_size_in_bytes": mem["argument"],
        "mem_output_size_in_bytes": mem["output"],
        "mem_temp_size_in_bytes": mem["temp"],
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


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def clear_dtensor_caches(fast_path: bool = False) -> None:
    """Empty DTensor's caches of sharding and redistribution plans and
    the fake-tensor cache. On a miss the plan is worked out with small ops
    that the counters may see; from the same empty caches every count
    sees the same ones (the first layer's), whatever was counted
    before. ``fast_path``: also the C++ fast path's cache of sharding
    propagation (torch >= 2.13), whose hits the counters never see;
    kept, it makes counts faster, but its plans hold the mesh they were
    made on (``mesh.fake_mesh``)."""
    from torch.distributed.tensor import _redistribute
    if fast_path and hasattr(torch._C,
                             "_clear_DTensor_sharding_propagator_cache"):
        torch._C._clear_DTensor_sharding_propagator_cache()
    prop = DTensor._op_dispatcher.sharding_propagator
    for fn in (getattr(prop, "propagate_op_sharding", None),
               getattr(type(prop), "_propagate_tensor_meta_cached", None),
               getattr(_redistribute, "_gen_transform_infos", None)):
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()
    if hasattr(_redistribute, "clear_redistribute_planner_cache"):
        _redistribute.clear_redistribute_planner_cache()
    # and fake-tensor shape propagation, whose misses run meta kernels
    from torch._subclasses.fake_tensor import FakeTensorMode
    if hasattr(FakeTensorMode, "cache_clear"):
        FakeTensorMode.cache_clear()


def count_step(step, args) -> Dict[str, int]:
    """One card's counts of one call ``step(*args)``, the arguments plain
    tensors (one card) or ``DTensor``s (rank 0 of a mesh, its blocks):
    FLOPs, bytes moved, each collective kind's result bytes and the
    number of collectives (``coll_count``), result bytes (``output``) and
    ``temp``, the peak of live tensors (``MemTracker``) less the
    arguments and the results that are not arguments (ints)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    clear_dtensor_caches()
    arg_t = [_local(t) for t in _tensors(args)]
    tracker = MemTracker()
    tracker.track_external(*arg_t)
    device = arg_t[0].device
    with tracker, FlopCounter(device) as fc, ByteCounter(device) as bc, \
            CollectiveCounter(device) as cc:
        out = step(*args)
    out_t = [_local(t) for t in _tensors(out)]
    held = {t.untyped_storage()._cdata for t in arg_t}
    new = sum(tensor_bytes(t) for t in out_t
              if t.untyped_storage()._cdata not in held)
    peak = tracker.get_tracker_snapshot("peak")[device]["Total"]
    return {"flops": int(fc.total), "bytes": int(bc.total),
            **cc.bytes, "coll_count": cc.count,
            "output": sum(map(tensor_bytes, out_t)),
            "temp": peak - sum(map(tensor_bytes, arg_t)) - new}
