"""Production meshes, as logical meshes counted in H100s.

Single pod: 256 cards as (data=16, model=16).
Multi-pod:  2 x 256 as (pod=2, data=16, model=16) — the ``pod`` axis is
the Cronus instance boundary (pod 0 = the CPI's slice, pod 1 = the
PPI's), and also the data-parallel axis across hosts for training shapes.

The JAX package builds these meshes on host-faked devices. Here a
:class:`LogicalMesh` is only the axes and their sizes (the partition
specs read nothing else), and :func:`fake_mesh` builds the real thing
for one process: a ``DeviceMesh`` of any shape over a ``"fake"``
process group, whose collectives move nothing. The dry-run runs its
step on rank 0 of it as ``DTensor``s, so the partitioner places the
collectives and each op runs at one card's shapes.

A process mesh is the real thing: :func:`process_mesh` lays the ranks of
an initialised ``torch.distributed`` default group (:func:`init_gloo`)
out as a named ``DeviceMesh``, which ``models.sharding.set_rules`` hands
to the model code (the expert-parallel MoE block).
"""
from __future__ import annotations

import contextlib
import datetime
import math
from typing import Dict, Iterator, Sequence

# a rank that waits longer than this on a collective fails the run
GROUP_TIMEOUT = datetime.timedelta(minutes=5)


class LogicalMesh:
    """Named mesh axes and their sizes: ``.shape`` maps each axis to its
    size in order, ``.size`` is their product (the number of cards)."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def __repr__(self) -> str:
        return f"LogicalMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(dict(zip(axes, shape)))


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda", rank: int = 0) -> Iterator:
    """A ``DeviceMesh`` of ``shape`` named by ``axes``, as ``rank`` of a
    ``"fake"`` process group of ``prod(shape)`` ranks (no process, no
    communication: a collective returns its input's shape unfilled; the
    SSM core's column exchange moves a different number of columns to
    each card, so its count is the given rank's). The
    group is destroyed on exit, on error too. Raises ``RuntimeError`` if
    a default group already exists: a run never borrows another's
    group. ``device_type`` is the kind of card the mesh stands for, which
    picks DTensor's collectives (on ``"cpu"`` a shard-to-shard move is an
    all-gather, gloo having no all-to-all there; on ``"cuda"`` it is an
    all-to-all); no card is touched either way."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.roofline import clear_dtensor_caches
    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a default process group already "
                           "exists")
    # DTensor's cached plans hold the mesh they were made on, whose
    # groups are named by rank: a mesh at a rank other than 0 (the
    # dry-run's) takes no plan made on another mesh and leaves none
    if rank:
        clear_dtensor_caches(fast_path=True)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    try:
        yield flatten_axes(init_device_mesh(device_type, tuple(shape),
                                            mesh_dim_names=tuple(axes)))
    finally:
        dist.destroy_process_group()
        if rank:
            clear_dtensor_caches(fast_path=True)


def flatten_axes(mesh):
    """``mesh`` with every run of two or more adjacent axes also
    registered as one flattened axis, so that DTensor reduces a tensor
    partial over several axes (a gradient of replicated weights) in one
    collective over their ranks, as XLA does, not one per axis."""
    names = mesh.mesh_dim_names
    for i in range(len(names)):
        for j in range(i + 2, len(names) + 1):
            mesh[names[i:j]]._flatten()
    return mesh


def batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def sharding_rules(multi_pod: bool, cfg=None) -> dict:
    """Logical-axis -> mesh-axis mapping of the name-based parameter
    specs and the cache and input specs.

    Small-model policy: when d_model is small (whisper-base: 512), 16-way
    tensor parallelism makes every layer's activation all-reduce dominate.
    Such models REPLICATE weights (they fit per card many times over) and
    keep only batch sharding — the model axis then acts as extra batch
    parallelism."""
    rules = {
        "batch": batch_axes(multi_pod),
        "model": "model",
        "heads": "model",
        "ff": "model",
        "experts": "model",
        "vocab": "model",
        "kv_seq": "model",
    }
    rules["seq"] = None
    if cfg is not None and cfg.d_model < 2048 and not cfg.is_moe \
            and cfg.arch_type not in ("ssm", "hybrid"):
        rules.update({"model": None, "heads": None, "ff": None,
                      "vocab": None, "seq": "model"})
    return rules


def init_gloo(init_method: str, rank: int, world_size: int) -> None:
    """The default process group over gloo (``init_method``: a
    ``file://`` or ``tcp://localhost:<port>`` rendezvous). gloo on CUDA
    tensors too: NCCL refuses two ranks on one card, and left to itself
    ``init_device_mesh("cuda", ...)`` would pick it. A rank that waits
    longer than ``GROUP_TIMEOUT`` on a collective raises."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world_size, timeout=GROUP_TIMEOUT)


def process_mesh(shape: Sequence[int], axes: Sequence[str], device):
    """The ranks of the initialised default group as a ``DeviceMesh`` of
    ``shape`` named by ``axes`` (rank ``r`` at the row-major coordinate
    of ``r``) on ``device``'s type (``"cpu"`` or ``"cuda"``)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("process_mesh needs an initialised default "
                           "process group (init_gloo)")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} != world size "
                         f"{dist.get_world_size()}")
    return flatten_axes(init_device_mesh(torch.device(device).type,
                                         tuple(shape),
                                         mesh_dim_names=tuple(axes)))
