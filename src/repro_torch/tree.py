"""Nested-dict trees of tensors (the port's stand-in for JAX pytrees).

A tree is a dict whose values are trees or leaves; leaves are visited in
sorted-key order, the order ``jax.tree_util`` flattens a dict in, so a
flattened parameter or optimizer tree lines up with the JAX package's
(checkpoint manifests, gradient-norm sums).
"""
from __future__ import annotations


def leaves_with_paths(tree, prefix: tuple = ()) -> list:
    """[(path, leaf)] in sorted-key order; a path is a tuple of keys."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in leaves_with_paths(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in tree}
    return fn(tree, *rest)


def unflatten(example, flat: list):
    """A tree shaped like ``example`` over ``flat`` (in ``leaves``'
    order)."""
    it = iter(flat)

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        return next(it)

    out = go(example)
    if next(it, None) is not None:
        raise ValueError("more leaves than the example tree has")
    return out
