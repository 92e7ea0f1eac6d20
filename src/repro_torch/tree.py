"""Minimal pytree helpers over nested dicts, lists and tuples of tensors —
the shapes ``repro`` hands to ``jax.tree``.  ``None`` is an empty subtree."""

from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [] if tree is None else [tree]


# -- stacked trees: per-hospital trees with a leading hospital axis ----------
# The compiled engine's captured steps index hospitals with DEVICE tensors
# (a Python int would be baked into a captured graph for good).

def stack_trees(trees):
    """List of trees of the same shapes -> one tree with a leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_take(tree, i):
    """Hospital ``i``'s slice of a stacked tree, ``i`` a 1-element int64
    tensor on the tree's device; a copy, not a view."""
    return tree_map(lambda x: x.index_select(0, i)[0], tree)


def tree_put(tree, i, sub):
    """Write ``sub`` into hospital ``i``'s slice of a stacked tree, in
    place (``i`` as in ``tree_take``)."""
    tree_map(lambda x, y: x.index_copy_(0, i, y.unsqueeze(0)), tree, sub)


def tree_select(flag, new, old):
    """``new`` where the device flag (a 0-d bool tensor) is set, else
    ``old``: how a padding step of the pad-and-mask engine leaves params
    and optimizer state (Adam's count too) alone."""
    return tree_map(lambda a, b: torch.where(flag, a, b), new, old)
