"""Model-update aggregation, the server side of every round — the part of
``repro/core/aggregate.py`` the methods use: ``tree_mean`` (the SFLv2/v1
client sync), ``tree_weighted_mean`` and the default FedAvg rule
``WeightedMean``, and their forms over a stacked hospital axis for the
compiled engine (``stacked_mean_sync``, ``stacked_weighted_mean``), which
add the hospitals in the same order, so both engines' means are the same
floats.  The other five rules and ``SecAggregator`` are ROADMAP M9/M8.

``prev`` (the pre-round global params) makes a zero-weight round well
defined: it keeps the previous globals instead of dividing by zero.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_map


@torch.no_grad()
def tree_mean(trees):
    """Plain mean over a list of trees."""
    return tree_map(lambda *xs: sum(xs) / len(xs), *trees)


@torch.no_grad()
def tree_weighted_mean(trees, weights, prev=None):
    """Data-size-weighted mean over a list of trees.  With no weight
    anywhere the round is a no-op: ``prev`` comes back unchanged (without
    ``prev``, the unweighted mean)."""
    total = sum(weights)
    if total <= 0:
        return prev if prev is not None else tree_mean(trees)
    return tree_map(
        lambda *xs: sum(w * x for w, x in zip(weights, xs)) / total, *trees)


@torch.no_grad()
def stacked_mean_sync(stacked):
    """Every hospital's row of a stacked tree becomes the plain mean of
    all rows (the SFLv2/v1 client sync); a new stacked tree."""
    def one(x):
        n = x.shape[0]
        return (sum(x[i] for i in range(n)) / n).expand_as(x)
    return tree_map(one, stacked)


@torch.no_grad()
def stacked_weighted_mean(stacked, weights):
    """``tree_weighted_mean`` over the rows of a stacked tree, with the
    same scalar arithmetic (a captured round holds ``weights`` as
    constants)."""
    total = sum(weights)
    return tree_map(lambda x: sum(w * x[i] for i, w in enumerate(weights))
                    / total, stacked)


class WeightedMean:
    """Data-size-weighted FedAvg — the paper's aggregation and the
    default."""
    name = "weighted_mean"

    def aggregate_trees(self, trees, weights, prev=None):
        return tree_weighted_mean(trees, weights, prev)
