"""Flatten and rebuild nested containers of tensors in JAX's leaf order.

The port's pytrees are plain dicts, lists and tuples with tensors (or any
other object) at the leaves; ``None`` is an empty subtree, and a tuple
whose class sets ``_tree_leaf`` (``sharding.PartitionSpec``) is a leaf.
The order of the leaves is the reference's (``jax.tree_util``): dict
entries by sorted key, list and tuple entries by position.  The bucketed gradient transport
lays its wire buffer out in that order, and the checkpoint fingerprints
name leaves the reference's way (``"layers/attn/wq"``, ``"opt/[0]"``), so
buffers and manifests agree between the two packages.

>>> leaves, spec = flatten({"b": [1, (2, None)], "a": {"z": 3, "c": 4}})
>>> leaves
[4, 3, 1, 2]
>>> [name for name, _ in flatten_named({"b": [1, (2, None)], "a": {"z": 3}})]
['a/z', 'b/[0]', 'b/[1]/[0]']
>>> unflatten(spec, [40, 30, 10, 20])
{'a': {'c': 40, 'z': 30}, 'b': [10, (20, None)]}
"""
from __future__ import annotations

__all__ = ["flatten", "flatten_named", "unflatten", "tree_map"]

_LEAF = object()


def _walk(tree, path, out):
    """Append (path, leaf) pairs to ``out``; return the tree's spec."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        keys = sorted(tree)
        return (dict, tuple(keys),
                tuple(_walk(tree[k], path + (str(k),), out) for k in keys))
    if isinstance(tree, (list, tuple)) and not getattr(tree, "_tree_leaf",
                                                       False):
        return (type(tree), None,
                tuple(_walk(v, path + (f"[{i}]",), out)
                      for i, v in enumerate(tree)))
    out.append(("/".join(path), tree))
    return _LEAF


def flatten_named(tree) -> list[tuple[str, object]]:
    """``[(name, leaf), ...]`` in leaf order; a name joins the dict keys and
    ``[index]`` sequence positions on the way to the leaf with ``/``."""
    out = []
    _walk(tree, (), out)
    return out


def flatten(tree):
    """``(leaves, spec)``; ``unflatten(spec, leaves)`` rebuilds the tree."""
    out = []
    spec = _walk(tree, (), out)
    return [leaf for _, leaf in out], spec


def unflatten(spec, leaves):
    """The tree of ``spec`` with its leaves taken in order from ``leaves``."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return None
        if s is _LEAF:
            return next(it)
        kind, keys, children = s
        if kind is dict:
            return {k: build(c) for k, c in zip(keys, children)}
        return kind(build(c) for c in children)

    tree = build(spec)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("unflatten: more leaves than the tree holds")
    return tree


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    leaves, spec = flatten(tree)
    others = []
    for other in rest:
        o_leaves, o_spec = flatten(other)
        if o_spec != spec:
            raise ValueError("tree_map: trees of different structure")
        others.append(o_leaves)
    return unflatten(spec, [fn(*args) for args in zip(leaves, *others)])
