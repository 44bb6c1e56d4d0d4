"""Logical-axis rules over a process mesh, and name-based parameter
partition specs.

The counterpart of the JAX package's ``models/sharding.py``:

* :func:`set_rules` installs a mapping from logical axis names to mesh
  axis names, and the mesh, for the model code to read
  (:func:`get_rules`, :func:`get_mesh`). The mesh is a
  ``torch.distributed`` ``DeviceMesh`` whose ``mesh_dim_names`` are the
  rules' values (for example ``("data", "model")``), over which the MoE
  block dispatches its experts in parallel (``models/moe.py``). With no
  rules installed (tests, one process) the models run as on one device.
* Each parameter leaf gets a partition spec from its name (the last key
  of its path in the nested-dict tree), its rank and the rules of
  :func:`repro_torch.launch.mesh.sharding_rules`; a sharded dimension
  that the mesh axes do not divide evenly is left whole. The specs are
  :class:`P` tuples of the port's own, whose entries are those of JAX's
  ``PartitionSpec``: a mesh-axis name, a tuple of names, or ``None``.
  They serve the dry-run's per-device memory accounting, and
  :func:`shard_experts` slices the routed experts by them.
* :func:`maybe_shard` is JAX's activation constraint: under installed
  rules it redistributes a ``DTensor`` to the placements that the rules
  give its logical axes (:func:`mesh_placements`); a plain tensor, or no
  rules, passes through as it is. The model code calls it where the JAX
  package does: after the embedding, on the logits and on the MoE
  block's capacity buffers.
* :func:`local_shard` cuts a whole tensor to one rank's block under a
  spec, and :func:`mesh_placements` turns a spec into ``DTensor``
  placements, so the dry-run and a process mesh lay a leaf out alike.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


class P(tuple):
    """A partition spec: one entry per dimension (a mesh-axis name, a
    tuple of names, or ``None``); trailing dimensions left out are
    unsharded. As JAX's ``PartitionSpec`` does, a list entry becomes a
    tuple, a one-name tuple the name and an empty one ``None``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (list, tuple)):
                e = tuple(e)
                return e[0] if len(e) == 1 else (e or None)
            return e
        return super().__new__(cls, map(norm, entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


_RULES: Optional[dict] = None
_MESH = None


def set_rules(rules: Optional[dict], mesh=None) -> None:
    """Install ``rules`` and ``mesh`` for the model code (``None``: run
    as one device). Every rank of the mesh installs the same rules."""
    global _RULES, _MESH
    _RULES = rules
    _MESH = mesh


def get_rules() -> Optional[dict]:
    return _RULES


def get_mesh():
    return _MESH


def maybe_shard(x, *logical_axes):
    """``x`` laid out as the installed rules place ``logical_axes`` (one
    per dimension; ``None`` keeps a dimension whole): a ``DTensor`` is
    redistributed to those placements, the counterpart of JAX's
    ``with_sharding_constraint``; a plain tensor, or no rules, is
    returned as it is. A dimension the mesh axes do not divide is left
    whole (:func:`divisible_spec`)."""
    if _RULES is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    spec = divisible_spec(P(*[_RULES.get(a) if a else None
                              for a in logical_axes]), x.shape, mesh)
    return x.redistribute(mesh, mesh_placements(spec, mesh))


def _axis_names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def mesh_placements(spec: P, mesh) -> List:
    """The ``DTensor`` placements of ``spec`` on a ``DeviceMesh``: mesh
    dimension ``i`` shards the tensor dimension whose entry names it, and
    replicates it otherwise (an axis of size 1 replicates: it splits
    nothing). An entry naming several axes must name them in the mesh's
    order, which is JAX's major-to-minor split."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _axis_names(entry)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in where:
            if mesh.size(i) > 1:
                out[i] = Shard(dim)
    return out


def local_shard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The block of ``t`` that this rank holds on ``mesh`` under
    ``spec``, a new contiguous tensor. A dimension split over several axes is cut in
    their mixed-radix order, major axis first; every split must be
    even."""
    names = list(mesh.mesh_dim_names)
    sizes = _sizes(mesh)
    coord = mesh.get_coordinate()
    out = t
    for dim, entry in enumerate(spec):
        axes = _axis_names(entry)
        if not axes:
            continue
        n = math.prod(sizes[a] for a in axes)
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does "
                             f"not split {n} ways")
        block = 0
        for a in axes:
            block = block * sizes[a] + coord[names.index(a)]
        step = t.shape[dim] // n
        out = out.narrow(dim, block * step, step)
    return out.clone(memory_format=torch.contiguous_format)


def axis_group(mesh, axes):
    """The process group of one axis of ``mesh`` (a name, or a tuple of
    one name, as a rule's value); ``None`` for no axis."""
    if isinstance(axes, (tuple, list)):
        if len(axes) > 1:
            raise ValueError(f"rule {axes!r}: a process mesh takes one "
                             f"axis per rule")
        axes = axes[0] if axes else None
    return None if axes is None else mesh.get_group(axes)


def _base_spec(name: str, ndim: int, rules: dict,
               is_expert: bool = False) -> P:
    m = rules.get("model")
    table = {
        # attention
        "wq": P(None, m), "wk": P(None, m), "wv": P(None, m), "wo": P(m, None),
        # MLA
        "w_dkv": P(None, None), "w_kpe": P(None, None),
        "w_uk": P(None, m, None), "w_uv": P(None, m, None),
        "w_dq": P(None, None), "w_uq": P(None, m, None),
        # mlp
        "w_gate": P(None, m), "w_up": P(None, m), "w_down": P(m, None),
        # moe (expert-parallel)
        "router": P(None, m),
        # embeddings
        "embed": P(m, None), "head": P(None, m),
        # ssm
        "in_proj": P(None, m), "out_proj": P(m, None),
        "conv_w": P(None, m), "conv_b": P(m),
    }
    spec = table.get(name)
    if spec is None:
        return P(*([None] * ndim))
    if is_expert and name in ("w_gate", "w_up", "w_down"):
        # expert-stacked weights [..., E, d, f]: shard the expert dim
        return P(m, None, None)
    return spec


def param_pspec(path: tuple, leaf, rules: dict) -> P:
    """The spec of one leaf. path: the tuple of its nested-dict keys;
    leaf: anything with a ``.shape``."""
    names = [n for n in path if isinstance(n, str)]
    name = names[-1] if names else None
    is_expert = "moe" in names and "shared_" not in " ".join(names)
    ndim = len(leaf.shape)
    if name is None:
        return P(*([None] * ndim))
    base = _base_spec(name, ndim, rules, is_expert=is_expert)
    # account for extra leading stacking dims (layers, shared experts...)
    extra = ndim - len(base)
    if extra > 0:
        return P(*([None] * extra + list(base)))
    if extra < 0:  # scalar-ish leaves
        return P(*([None] * ndim))
    return base


def _sizes(mesh) -> Dict[str, int]:
    """Each axis's size, of a logical mesh or a ``DeviceMesh``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return mesh.shape


def _axis_size(mesh, axis) -> int:
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in _axis_names(axis))


def divisible_spec(spec: P, shape, mesh) -> P:
    """Drop sharding on any dim the mesh axes don't evenly divide."""
    fixed = []
    for i, axis in enumerate(spec):
        n = _axis_size(mesh, axis)
        fixed.append(axis if (n > 1 and shape[i] % n == 0) or n == 1 else None)
    return P(*fixed)


def shard_count(spec: P, mesh) -> int:
    """How many ways ``spec`` splits a leaf over ``mesh`` (the product of
    the sizes of the axes it names)."""
    n = 1
    for axis in spec:
        n *= _axis_size(mesh, axis)
    return n


def params_sharding_tree(params_or_shapes: Dict, mesh, rules: dict,
                         path: tuple = ()) -> Dict:
    """A tree of :class:`P` beside a nested dict of leaves with
    ``.shape``, each made divisible over ``mesh``."""
    out = {}
    for k, v in params_or_shapes.items():
        if isinstance(v, dict):
            out[k] = params_sharding_tree(v, mesh, rules, path + (k,))
        else:
            spec = param_pspec(path + (k,), v, rules)
            out[k] = divisible_spec(spec, v.shape, mesh)
    return out


def shard_experts(params: Dict, mesh, rules: dict,
                  path: tuple = ()) -> Dict:
    """``params`` with every routed-expert leaf (``w_gate``, ``w_up``,
    ``w_down`` under a ``moe`` key, not ``shared_*``) cut to this rank's
    slice of the expert dimension, as :func:`param_pspec` shards it: the
    block of ``E / n`` experts at this rank's coordinate on the spec's
    mesh axis, which must be ``rules["experts"]``. The slices are copies
    (the full leaf can be freed); every other leaf is kept as it is.
    Raises ``ValueError`` when the axis does not divide ``E`` (JAX's
    ``E // n`` would silently drop experts) or the spec shards another
    axis."""
    out = {}
    for k, v in params.items():
        where = path + (k,)
        if isinstance(v, dict):
            out[k] = shard_experts(v, mesh, rules, where)
            continue
        names = [n for n in where if isinstance(n, str)]
        if k not in ("w_gate", "w_up", "w_down") or "moe" not in names \
                or "shared_" in " ".join(names):
            out[k] = v
            continue
        spec = param_pspec(where, v, rules)
        dims = [(i, a) for i, a in enumerate(spec) if a is not None]
        if len(dims) != 1 or dims[0][1] != rules.get("experts"):
            raise ValueError(f"params{list(where)}: spec {spec} does not "
                             f"shard the experts on rules['experts'] = "
                             f"{rules.get('experts')!r}")
        dim, axis = dims[0]
        n, e = mesh[axis].size(), v.shape[dim]
        if e % n:
            raise ValueError(f"params{list(where)}: {e} experts do not "
                             f"split over {n} ranks of {axis!r}")
        e_loc = e // n
        out[k] = v.narrow(dim, mesh.get_local_rank(axis) * e_loc,
                          e_loc).clone()
    return out
