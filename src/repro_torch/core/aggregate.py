"""Model-update aggregation, the server side of every round — the part of
``repro/core/aggregate.py`` the methods use: ``tree_mean`` (the SFLv2/v1
client sync), ``tree_weighted_mean`` and the default FedAvg rule
``WeightedMean``, and their forms over a stacked hospital axis for the
compiled engine (``stacked_mean_sync``, ``stacked_weighted_mean``), which
add the hospitals in the same order, so both engines' means are the same
floats; and ``SecAggregator``, FedAvg under ``privacy.secagg``.  The
other four rules and the registry are ROADMAP M9.

``prev`` (the pre-round global params) makes a zero-weight round well
defined: it keeps the previous globals instead of dividing by zero.
"""

from __future__ import annotations

import numpy as np
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


class SecAggregator:
    """Pairwise-mask secure aggregation (``privacy.secagg.SecAgg``) of
    model params: the locals go to the host in the reference's layout
    (``interop.params_to_numpy``: HWIO conv weights), so each masked
    upload is the one the reference's hospital sends for the same model;
    the server adds them modulo 2^32, and the weighted mean comes back in
    the port's layout, device and dtype.  A host-side protocol, so the
    compiled engine runs it after each round's replays instead of a
    captured round body.  With no weight anywhere the round keeps
    ``prev``."""
    name = "secagg"

    def __init__(self, secagg):
        self.secagg = secagg

    def aggregate_trees(self, trees, weights, prev=None):
        from repro_torch.interop import params_from_jax, params_to_numpy
        if float(np.sum(np.asarray(weights, np.float64))) <= 0:
            return prev if prev is not None else tree_mean(trees)
        agg = self.secagg.aggregate_weighted(
            [params_to_numpy(t) for t in trees], [float(w) for w in weights])
        # walk the locals' tree, so the result keeps their key order
        return tree_map(lambda old, a: a.to(device=old.device,
                                            dtype=old.dtype),
                        trees[0], params_from_jax(agg))
