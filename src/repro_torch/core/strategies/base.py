"""Strategy API + the SplitFedv3 step — counterpart of
``repro/core/strategies/base.py`` (stepwise engine, non-private).

Every strategy consumes a ``SplitAdapter`` and an optimizer factory and
exposes ``setup(seed) -> state``, ``run_epoch(state, client_data, rng,
batch_size) -> (state, log)``, ``evaluate``, ``val_loss`` and ``scores``.
``client_data`` is a list (one per hospital) of dicts of numpy arrays;
batches are drawn on the host with the reference's numpy rng stream and
moved to the strategy's device.  Evaluation follows the paper (§3.4): a
sample from hospital i always passes through hospital i's own client
segment(s).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.partition import SplitAdapter, detached
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class EpochLog:
    """Per-epoch training log (see the reference for ``weights``)."""
    losses: list
    steps: int
    weights: list | None = None
    client_steps: list[int] | None = None

    @property
    def mean_loss(self):
        if not self.losses:
            return float("nan")
        if self.weights is None:
            return float(np.mean(self.losses))
        w = np.asarray(self.weights, dtype=np.float64)
        l = np.asarray(self.losses, dtype=np.float64)
        return float((l * w).sum() / max(w.sum(), 1.0))


def np_batches(data: dict, batch_size: int, rng: np.random.Generator | None):
    """Shuffle + slice a client's epoch into full batch dicts, the short
    remainder dropped (the reference's numpy stream with its default
    ``drop_remainder=True``: the same rng gives the same batches)."""
    n = len(next(iter(data.values())))
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    stop = (n // batch_size) * batch_size
    return [{k: v[idx[s:s + batch_size]] for k, v in data.items()}
            for s in range(0, stop, batch_size)]


class Strategy:
    name: str = "base"

    def __init__(self, adapter: SplitAdapter, opt_factory: Callable[[], Optimizer],
                 n_clients: int, device: torch.device,
                 engine: str = "stepwise"):
        if engine != "stepwise":
            raise NotImplementedError(
                f"engine={engine!r}: the port has the stepwise engine only "
                "(compiled engine: ROADMAP M6)")
        self.adapter = adapter
        self.opt_factory = opt_factory
        self.n_clients = n_clients
        self.device = device
        self.engine = engine

    # -- to implement ---------------------------------------------------------
    def setup(self, seed=0):
        raise NotImplementedError

    def run_epoch(self, state, client_data, rng, batch_size):
        raise NotImplementedError

    def params_for_eval(self, state, client_idx) -> dict:
        """Full param dict (all segments) used to score client ``client_idx``."""
        raise NotImplementedError

    # -- common ---------------------------------------------------------------
    def to_device(self, batch: dict) -> dict:
        """numpy batch -> tensors on the strategy's device (only the keys
        the adapter reads)."""
        keys = self.adapter.batch_keys or tuple(batch)
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(
            self.device) for k in keys}

    @torch.no_grad()
    def scores(self, state, client_idx, data, batch_size=60):
        """Per-sample scores for EVERY sample of one hospital."""
        n = len(data["label"])
        if n == 0:
            return np.zeros((0,))
        params = self.params_for_eval(state, client_idx)
        bs = min(batch_size, n)
        out = [self.adapter.full_scores(
            params, self.to_device({k: v[s:s + bs] for k, v in data.items()}))
            for s in range(0, n, bs)]
        return torch.cat(out).cpu().numpy()

    def scores_all(self, state, datas: list, batch_size=60):
        """Per-sample scores of every hospital, each by its own segments."""
        return [self.scores(state, i, d, batch_size)
                for i, d in enumerate(datas)]

    def evaluate(self, state, clients, split="test", batch_size=60):
        """Pooled metrics across clients, each scored by its own front."""
        from repro_torch.train import metrics as MET
        datas = [getattr(c, split) for c in clients]
        scores = self.scores_all(state, datas, batch_size)
        all_labels = [d["label"][:len(s)] for d, s in zip(datas, scores)]
        return MET.all_metrics(np.concatenate(all_labels),
                               np.concatenate(scores))

    @torch.no_grad()
    def val_loss(self, state, clients, batch_size=60):
        losses = []
        for i, c in enumerate(clients):
            params = self.params_for_eval(state, i)
            for b in np_batches(c.val, min(batch_size, len(c.val["label"])),
                                None):
                losses.append(self.adapter.full_loss(
                    params, self.to_device(b), train=False))
        if not losses:
            return 0.0
        return sum(torch.stack(losses).cpu().tolist()) / len(losses)


# ---------------------------------------------------------------------------
# the SplitFedv3 step
# ---------------------------------------------------------------------------

def _cat(trees):
    return tree_map(lambda *ls: torch.cat(ls), trees[0], *trees[1:])


def _split(tree, sizes):
    offs = np.cumsum([0, *sizes])
    return [tree_map(lambda t: t[offs[i]:offs[i + 1]], tree)
            for i in range(len(sizes))]


def sflv3_step_fn(adapter: SplitAdapter, opt_client: Optimizer,
                  opt_server: Optimizer, n_clients: int, transport=None):
    """SplitFedv3 step (paper Algorithm 1, batch-synchronous form; the
    reference's ``base.sflv3_step_fn`` without privacy or padding rows).

    Each hospital's batch runs through its own front; the fronts' outputs
    are concatenated along the batch axis, so the cut layer crosses the
    transport in ONE launch and the shared server segment runs once on
    all hospitals' rows (GroupNorm and convs are per example, so this
    equals one server pass per hospital).  The loss is the mean over
    hospitals of each hospital's mean loss: its gradient gives the server
    the mean of the per-hospital server gradients, and each client
    gradient is rescaled by ``n_clients`` back to that hospital's own,
    exactly as the reference does.

    ``step(clients, server, c_opts, s_opt, batches)`` takes per-hospital
    lists of client trees, optimizer states and device batches and returns
    the updated ``(clients, server, c_opts, s_opt, losses)``, ``losses`` a
    detached (n_clients,) tensor.
    """
    boundary = transport.boundary if transport is not None else None

    def step(clients, server, c_opts, s_opt, batches):
        cps = [detached(cp, True) for cp in clients]
        sp = detached(server, True)
        joint = {k: torch.cat([b[k] for b in batches]) for k in batches[0]}
        fronts = [adapter.apply_seg("front", cp["front"], adapter.inputs(b),
                                    b, True) for cp, b in zip(cps, batches)]
        sizes = [tree_leaves(f)[0].shape[0] for f in fronts]
        h = _cat(fronts)
        if boundary is not None:
            h = boundary(h)
        h = adapter.apply_seg("middle", sp, h, joint, True)
        losses = torch.stack([adapter.loss_from_output(o, b)
                              for o, b in zip(_split(h, sizes), batches)])
        c_leaves = [tree_leaves(cp) for cp in cps]
        s_leaves = tree_leaves(sp)
        grads = torch.autograd.grad(losses.sum() / n_clients,
                                    [l for ls in c_leaves for l in ls]
                                    + s_leaves)
        grads = iter(grads)
        gcs = [tree_map(lambda _: next(grads) * n_clients, cp) for cp in cps]
        gs = tree_map(lambda _: next(grads), sp)

        new_clients, new_c_opts = [], []
        for cp, gc, co in zip(clients, gcs, c_opts):
            cu, co = opt_client.update(gc, co)
            new_clients.append(apply_updates(cp, cu))
            new_c_opts.append(co)
        su, s_opt = opt_server.update(gs, s_opt)
        return (new_clients, apply_updates(server, su), new_c_opts, s_opt,
                losses.detach())

    return step


__all__ = ["Strategy", "EpochLog", "np_batches", "sflv3_step_fn"]
