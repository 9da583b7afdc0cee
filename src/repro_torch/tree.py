"""Nested dicts of tensors (the port's parameter, gradient and optimizer
trees): a map over leaves, the leaves in the order JAX flattens a dict
(sorted keys), and a tree rebuilt from such a sequence."""

from __future__ import annotations

__all__ = ["tree_map", "leaves", "unflatten"]


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree):
    """The leaves in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def unflatten(like, values):
    """A tree of ``like``'s structure whose leaves are ``values`` (an
    iterable, in ``leaves`` order)."""
    it = iter(values)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)
    return walk(like)
