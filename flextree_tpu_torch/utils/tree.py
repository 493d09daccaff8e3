"""Tree helpers over the nested dict/list/tuple layout of the train state
and the gradients (the JAX package's ``jax.tree`` calls on that layout).
A dict's leaves come in the order of its sorted keys, as ``jax.tree``
flattens a dict, so the port's leaf order is the JAX package's: a lossy
bucket packs its leaves, and so quantizes them, as the JAX one does."""

from __future__ import annotations

__all__ = ["tree_map", "tree_leaves", "tree_unflatten"]


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of dict/list/tuple trees of one
    structure (the JAX ``jax.tree.map`` on the train-state layout)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a dict/list/tuple tree, in ``tree_map`` order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order) as
    its leaves."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
