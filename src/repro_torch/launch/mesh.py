"""Production meshes, as logical meshes counted in H100s.

Single pod: 256 cards as (data=16, model=16).
Multi-pod:  2 x 256 as (pod=2, data=16, model=16) — the ``pod`` axis is
the Cronus instance boundary (pod 0 = the CPI's slice, pod 1 = the
PPI's), and also the data-parallel axis across hosts for training shapes.

The JAX package builds these meshes on host-faked devices; one process
with one card can build no 256-device mesh, so here a mesh is only its
axes and their sizes. The dry-run reads nothing else of it.
"""
from __future__ import annotations

from typing import Dict


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
