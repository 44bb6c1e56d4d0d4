"""Nested dicts of tensors as flat ``'/'``-joined key paths: the part of
``jax.tree_util`` that the optimizer, the trainer and the checkpoint need.
Keys are walked in sorted order, as ``jax.tree_util`` orders a dict's
leaves, so leaf order and checkpoint keys are the JAX package's."""
from __future__ import annotations

from typing import Any, Callable, Dict


def flatten(tree: Dict, prefix: str = "") -> Dict[str, Any]:
    """``{'a/b/c': leaf}`` in the JAX package's leaf order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Dict:
    """The inverse of :func:`flatten`."""
    tree: Dict = {}
    for path, v in flat.items():
        *heads, last = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def tree_map(fn: Callable, tree: Dict, *rest: Dict) -> Dict:
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``, in the JAX package's leaf order."""
    others = [flatten(t) for t in rest]
    return unflatten({k: fn(v, *(o[k] for o in others))
                      for k, v in flatten(tree).items()})
