"""Nested containers of tensors as flat leaf lists (the part of JAX's
``tree_util`` the checkpoint and auto-capacity code use).

Containers are NamedTuples (the scene's tables, ``Camera``, ``DrawList``),
tuples, lists and dicts (keys in sorted order, as JAX orders them); None is
an empty subtree. Anything else (a tensor, an array, a number) is a leaf.
"""

from __future__ import annotations

_LEAF = object()


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree):
    """(leaves in order, the structure ``unflatten`` rebuilds from)."""
    leaves = []

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(walk(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(walk(x) for x in t)
        leaves.append(t)
        return _LEAF

    return leaves, walk(tree)


def leaves(tree) -> list:
    return flatten(tree)[0]


def unflatten(structure, new_leaves):
    """The tree of ``structure`` (from ``flatten``) with ``new_leaves`` in
    its leaves' places."""
    it = iter(new_leaves)

    def build(s):
        if s is _LEAF:
            return next(it)
        if s is None:
            return None
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        if _is_namedtuple(s):
            return type(s)(*(build(x) for x in s))
        return type(s)(build(x) for x in s)

    out = build(structure)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the structure holds")
    return out
