"""Model-update aggregation, the server side of every round — the part of
``repro/core/aggregate.py`` the stepwise methods use: ``tree_mean`` (the
SFLv2/v1 client sync), ``tree_weighted_mean`` and the default FedAvg rule
``WeightedMean``.  The other five rules and ``SecAggregator`` are ROADMAP
M9/M8.

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


class WeightedMean:
    """Data-size-weighted FedAvg — the paper's aggregation and the
    default."""
    name = "weighted_mean"

    def aggregate_trees(self, trees, weights, prev=None):
        return tree_weighted_mean(trees, weights, prev)
