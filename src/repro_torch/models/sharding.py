"""Name-based parameter partition specs over a logical mesh.

The counterpart of the name-based half of the JAX package's
``models/sharding.py``: each parameter leaf gets a partition spec from its
name (the last key of its path in the nested-dict tree), its rank and the
logical-axis rules of :func:`repro_torch.launch.mesh.sharding_rules`; a
sharded dimension that the mesh axes do not divide evenly is left whole.
The specs are :class:`P` tuples of the port's own, whose entries are those
of JAX's ``PartitionSpec``: a mesh-axis name, a tuple of names, or
``None``.

Left out: the JAX package's ``set_rules``/``maybe_shard`` activation
constraints. The port's models partition no activation (one process
drives one card), so the specs here serve the dry-run's per-device
memory accounting alone.
"""
from __future__ import annotations

from typing import Dict


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


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


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
