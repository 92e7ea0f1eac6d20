"""Model-update aggregation, the server side of every round — counterpart
of ``repro/core/aggregate.py``.

  * ``Aggregator.aggregate(stacked, weights, prev, staleness=None,
    gids=None)`` reduces a stacked tree (a leading hospital or
    participation-slot axis) under raw per-row ``weights``, a device
    tensor.  It is what a captured round body calls, so it runs inside a
    CUDA graph: no ``.item()``, no host branch on a weight and no copy
    from host memory.  The zero-weight guard (a round where nothing
    carries weight, such as a Poisson round that sampled nobody, keeps
    ``prev``) is a ``torch.where`` over tensors.
  * ``Aggregator.aggregate_trees`` is the list-of-trees form the stepwise
    engine calls: it stacks the trees and calls ``aggregate`` with the
    weights on their device, so both engines reduce with one arithmetic.
  * ``scan_compatible=False`` (secure aggregation, a host-side protocol)
    makes the compiled engine aggregate on the host after each round.

Registered rules (``AGGREGATORS``, ``make_aggregator``): ``weighted_mean``
(data-size FedAvg, the default), ``trimmed_mean`` and
``coordinate_median`` (robust), ``staleness_discounted`` (a hospital that
sat rounds out is weighted down by ``decay ** rounds``) and
``hierarchical`` (region means, then an unweighted mean over regions).
``SecAggregator`` is FedAvg under ``privacy.secagg``.  ``tree_mean`` and
``stacked_mean_sync`` are the SFLv2/v1 client sync.

Every sum over the hospital axis adds the rows one after another in row
order (``_row_sum``: no atomics, no reduction whose order may change), so
a run repeats bit for bit.  The weighted mean multiplies the weighted sum
by the reciprocal of the total weight: on the card that is what ATen's
division by a host scalar does, so the mean is the same floats whether
the weights came from the host or from a device buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import stack_trees, tree_leaves, tree_map


def _ordered_sum(terms):
    """The sum of an iterable of tensors, added in the order given."""
    terms = iter(terms)
    acc = next(terms)
    for t in terms:
        acc = acc + t
    return acc


def _row_sum(x):
    """``x[0] + x[1] + ...`` over the leading axis, in row order."""
    return _ordered_sum(x[i] for i in range(x.shape[0]))


def _rows(x, v):
    """A (rows,) vector ``v`` shaped to broadcast over ``x``'s rows."""
    return v.reshape((-1,) + (1,) * (x.ndim - 1))


@torch.no_grad()
def tree_mean(trees):
    """Plain mean over a list of trees."""
    return tree_map(lambda *xs: sum(xs) / len(xs), *trees)


@torch.no_grad()
def stacked_mean_sync(stacked):
    """Every hospital's row of a stacked tree becomes the plain mean of
    all rows (the SFLv2/v1 client sync); a new stacked tree."""
    def one(x):
        n = x.shape[0]
        return (sum(x[i] for i in range(n)) / n).expand_as(x)
    return tree_map(one, stacked)


@torch.no_grad()
def weighted_mean_guarded(stacked, weights, prev):
    """The weighted mean over the rows of ``stacked`` under raw device
    ``weights``, ``prev`` wherever the round carries no weight at all."""
    w = weights.to(torch.float32)
    total = _row_sum(w)
    has = total > 0
    inv = torch.reciprocal(torch.where(has, total, 1.0))

    def leaf(x, p):
        acc = _row_sum(x.to(torch.float32) * _rows(x, w))
        return torch.where(has, (acc * inv).to(x.dtype), p.to(x.dtype))
    return tree_map(leaf, stacked, prev)


class Aggregator:
    """One server-side aggregation rule.

    ``aggregate`` takes ``stacked``, a tree with a leading hospital (or
    participation-slot) axis, ``weights`` the raw per-row weights as a
    device tensor (zeros for empty slots), and ``prev`` the pre-round
    globals, returned where nothing carries weight.  ``staleness`` (rounds
    each row's hospital sat out since it last took part) and ``gids``
    (each row's global hospital id, -1 for an empty slot) are the
    per-round context of a participating run; ``None`` otherwise."""
    name = "base"
    scan_compatible = True

    def aggregate(self, stacked, weights, prev, staleness=None, gids=None):
        raise NotImplementedError

    def aggregate_trees(self, trees, weights, prev=None):
        """List-of-trees form (the stepwise engine)."""
        if prev is None:
            prev = trees[0]
        dev = tree_leaves(trees[0])[0].device
        w = torch.from_numpy(np.asarray(weights, np.float32)).to(dev)
        return self.aggregate(stack_trees(trees), w, prev)


class WeightedMean(Aggregator):
    """Data-size-weighted FedAvg — the paper's aggregation and the
    default."""
    name = "weighted_mean"

    def aggregate(self, stacked, weights, prev, staleness=None, gids=None):
        return weighted_mean_guarded(stacked, weights, prev)


class SecAggregator(Aggregator):
    """Pairwise-mask secure aggregation (``privacy.secagg.SecAgg``) of
    model params: the locals go to the host in the reference's layout
    (``interop.params_to_numpy``: HWIO conv weights), so each masked
    upload is the one the reference's hospital sends for the same model;
    the server adds them modulo 2^32, and the weighted mean comes back in
    the port's layout, device and dtype.  A host-side protocol
    (``scan_compatible=False``), so the compiled engine runs it after each
    round's replays instead of a captured round body.  With no weight
    anywhere the round keeps ``prev``."""
    name = "secagg"
    scan_compatible = False

    def __init__(self, secagg):
        self.secagg = secagg

    def aggregate(self, stacked, weights, prev, staleness=None, gids=None):
        raise RuntimeError("secagg is a host-side protocol; use "
                           "aggregate_trees")

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


def _sorted_valid(x, valid):
    """``x``'s rows in f32, sorted along the row axis with the rows of
    no weight (``valid`` False) replaced by +inf, so they sort last."""
    xs = torch.where(_rows(x, valid), x.to(torch.float32), torch.inf)
    return torch.sort(xs, dim=0).values


class TrimmedMean(Aggregator):
    """Coordinate-wise trimmed mean over the rows with positive weight
    (Byzantine-robust; Yin et al. 2018).  Weights gate validity only: the
    surviving coordinates average unweighted.  Trims ``floor(trim *
    n_valid)`` from each end, capped so at least one row survives."""
    name = "trimmed_mean"

    def __init__(self, trim: float = 0.1):
        if not 0.0 <= trim < 0.5:
            raise ValueError("trim must be in [0, 0.5)")
        self.trim = float(trim)

    @torch.no_grad()
    def aggregate(self, stacked, weights, prev, staleness=None, gids=None):
        valid = weights > 0
        n = valid.sum()
        k = torch.minimum(
            torch.floor(self.trim * n.to(torch.float32)).to(torch.int64),
            torch.clamp((n - 1) // 2, min=0))
        denom = torch.clamp(n - 2 * k, min=1).to(torch.float32)

        def leaf(x, p):
            xs = _sorted_valid(x, valid)
            ranks = _rows(x, torch.arange(x.shape[0], device=x.device))
            keep = (ranks >= k) & (ranks < n - k)
            total = _row_sum(torch.where(keep, xs, 0.0))
            return torch.where(n > 0, (total / denom).to(x.dtype),
                               p.to(x.dtype))
        return tree_map(leaf, stacked, prev)


class CoordinateMedian(Aggregator):
    """Coordinate-wise median over the rows with positive weight (robust;
    an even count averages the two middle order statistics)."""
    name = "coordinate_median"

    @torch.no_grad()
    def aggregate(self, stacked, weights, prev, staleness=None, gids=None):
        valid = weights > 0
        n = valid.sum()
        lo = torch.clamp((n - 1) // 2, min=0).reshape(1)
        hi = (n // 2).reshape(1)

        def leaf(x, p):
            xs = _sorted_valid(x, valid)
            med = (xs.index_select(0, lo)[0] + xs.index_select(0, hi)[0]) / 2
            return torch.where(n > 0, med.to(x.dtype), p.to(x.dtype))
        return tree_map(leaf, stacked, prev)


class StalenessDiscounted(Aggregator):
    """Asynchronous / buffered FedAvg: each update's data-size weight is
    further discounted by ``decay ** staleness``, ``staleness`` the rounds
    a hospital sat out since it last took part (0 when fresh or first
    seen), so a rarely sampled hospital re-entering a participating run
    pulls the globals less hard."""
    name = "staleness_discounted"

    def __init__(self, decay: float = 0.5):
        if not 0.0 < decay <= 1.0:
            raise ValueError("decay must be in (0, 1]")
        self.decay = float(decay)

    def aggregate(self, stacked, weights, prev, staleness=None, gids=None):
        w = weights.to(torch.float32)
        if staleness is not None:
            w = w * torch.pow(self.decay, staleness.to(torch.float32))
        return weighted_mean_guarded(stacked, w, prev)


class Hierarchical(Aggregator):
    """Two-tier region -> global aggregation: the data-size-weighted mean
    WITHIN each region, then an UNWEIGHTED mean over the non-empty
    regions, so every region gets one vote whatever its cohort's size.
    ``regions[g]`` maps global hospital ``g`` to its region; a
    participating run resolves slot rows through ``gids``.  The region
    sums add the rows in row order (a one-hot product per row, not a
    scatter with atomics)."""
    name = "hierarchical"

    def __init__(self, regions):
        self.regions = tuple(int(r) for r in regions)
        if any(r < 0 for r in self.regions):
            raise ValueError("region ids must be >= 0")
        self.n_regions = max(self.regions) + 1 if self.regions else 0
        self._tables: dict = {}       # device -> (regions, range(R))

    def _table(self, device):
        """The region table on ``device``, made once (before any capture:
        a program's warm-up calls the round body first)."""
        if device not in self._tables:
            self._tables[device] = (
                torch.tensor(self.regions, dtype=torch.int64, device=device),
                torch.arange(self.n_regions, device=device))
        return self._tables[device]

    @torch.no_grad()
    def aggregate(self, stacked, weights, prev, staleness=None, gids=None):
        reg, ids = self._table(weights.device)
        C = weights.shape[0]
        r = reg[:C] if gids is None else reg.index_select(
            0, torch.clamp(gids, min=0))
        onehot = (r[None, :] == ids[:, None]).to(torch.float32)   # [R, C]
        wf = weights.to(torch.float32)
        reg_w = _row_sum((onehot * wf).T)                          # [R]
        nonempty = (reg_w > 0).to(torch.float32)
        n_r = _row_sum(nonempty)
        den = torch.clamp(reg_w, min=1e-12)[:, None]

        def leaf(x, p):
            wx = x.reshape(C, -1).to(torch.float32) * wf[:, None]
            s = _ordered_sum(onehot[:, i, None] * wx[i] for i in range(C))
            g = _row_sum(s / den * nonempty[:, None]) / torch.clamp(n_r,
                                                                    min=1.0)
            return torch.where(n_r > 0, g.reshape(x.shape[1:]).to(x.dtype),
                               p.to(x.dtype))
        return tree_map(leaf, stacked, prev)


AGGREGATORS: dict = {
    "weighted_mean": WeightedMean,
    "trimmed_mean": TrimmedMean,
    "coordinate_median": CoordinateMedian,
    "staleness_discounted": StalenessDiscounted,
    "hierarchical": Hierarchical,
}


def register(name: str, cls) -> None:
    """Add an ``Aggregator`` subclass to the registry."""
    AGGREGATORS[name] = cls


def make_aggregator(spec=None) -> Aggregator:
    """``None`` -> the default ``WeightedMean``; a registered name -> that
    rule with its default parameters; an ``Aggregator`` passes through
    (the way to set ``trim``, ``decay`` or ``regions``)."""
    if spec is None:
        return WeightedMean()
    if isinstance(spec, Aggregator):
        return spec
    if isinstance(spec, str):
        if spec not in AGGREGATORS:
            raise ValueError(f"unknown aggregator {spec!r}; "
                             f"registered: {sorted(AGGREGATORS)}")
        return AGGREGATORS[spec]()
    raise TypeError(f"aggregator spec must be None, a name, or an "
                    f"Aggregator, got {type(spec).__name__}")


__all__ = ["Aggregator", "WeightedMean", "SecAggregator", "TrimmedMean",
           "CoordinateMedian", "StalenessDiscounted", "Hierarchical",
           "AGGREGATORS", "register", "make_aggregator", "tree_mean",
           "stacked_mean_sync", "weighted_mean_guarded"]
