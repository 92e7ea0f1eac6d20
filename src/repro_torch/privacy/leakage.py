"""Cut-layer leakage metrics — what a curious server learns from smashed
activations.  The port's copy of ``repro/privacy/leakage.py``.

Vepakomma et al.'s *No Peek* frames the central split-learning risk as
server-side inference from the cut-layer tensors.  Two complementary
measurements, both evaluated on EXACTLY what crosses the wire (the
activations are pulled through the transport boundary and any cut-layer
noise before measuring):

  * ``distance_correlation`` — nonparametric statistical dependence between
    smashed activations and raw inputs / labels (0 = independent, 1 =
    deterministically related); the No-Peek leakage measure.
  * reconstruction / label probes — ridge-regression attacks fit on a train
    split of the smashed activations and scored on a held-out split:
    input-reconstruction R^2 and label-probe AUROC.  These are the
    cheapest honest-but-curious attacks; stronger attackers only do better,
    so probe numbers are leakage LOWER bounds.

The metrics are numpy in float64, evaluation-time only; only
``smashed_activations`` runs the model (the port's adapter, transport and
cut noise, on the params' device).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_leaves


def _pairwise_dists(x: np.ndarray) -> np.ndarray:
    """(n, d) -> (n, n) Euclidean distance matrix via the gram trick."""
    sq = (x * x).sum(axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    return np.sqrt(np.maximum(d2, 0.0))


def _double_center(d: np.ndarray) -> np.ndarray:
    return (d - d.mean(axis=0, keepdims=True) - d.mean(axis=1, keepdims=True)
            + d.mean())


def distance_correlation(x, y) -> float:
    """Szekely's distance correlation between row-paired samples."""
    x = np.asarray(x, np.float64).reshape(len(x), -1)
    y = np.asarray(y, np.float64).reshape(len(y), -1)
    if len(x) != len(y):
        raise ValueError(f"paired samples required: {len(x)} vs {len(y)}")
    a = _double_center(_pairwise_dists(x))
    b = _double_center(_pairwise_dists(y))
    dcov2 = (a * b).mean()
    dvar_x, dvar_y = (a * a).mean(), (b * b).mean()
    denom = np.sqrt(dvar_x * dvar_y)
    if denom <= 0:
        return 0.0
    return float(np.sqrt(max(dcov2, 0.0) / denom))


def _ridge_fit(z: np.ndarray, t: np.ndarray, l2: float) -> np.ndarray:
    """Closed-form ridge: (n, d) acts, (n, k) targets -> (d+1, k) weights."""
    z1 = np.concatenate([z, np.ones((len(z), 1))], axis=1)
    gram = z1.T @ z1 + l2 * np.eye(z1.shape[1])
    return np.linalg.solve(gram, z1.T @ t)


def _ridge_predict(z: np.ndarray, w: np.ndarray) -> np.ndarray:
    return np.concatenate([z, np.ones((len(z), 1))], axis=1) @ w


def _split(n: int, train_frac: float, seed: int):
    """The probes' seeded train / held-out split (all rows for both when
    nothing is held out)."""
    idx = np.random.default_rng(seed).permutation(n)
    n_tr = max(int(train_frac * n), 1)
    tr, te = idx[:n_tr], idx[n_tr:]
    return (idx, idx) if len(te) == 0 else (tr, te)


def reconstruction_probe(acts, inputs, l2: float = 1e-2,
                         train_frac: float = 0.7, seed: int = 0) -> dict:
    """Linear input-reconstruction attack; returns held-out R^2 and MSE."""
    z = np.asarray(acts, np.float64).reshape(len(acts), -1)
    t = np.asarray(inputs, np.float64).reshape(len(inputs), -1)
    tr, te = _split(len(z), train_frac, seed)
    w = _ridge_fit(z[tr], t[tr], l2)
    pred = _ridge_predict(z[te], w)
    resid = ((pred - t[te]) ** 2).mean()
    var = t[te].var()
    r2 = 1.0 - resid / max(var, 1e-12)
    return {"r2": float(max(r2, 0.0)), "mse": float(resid),
            "baseline_var": float(var)}


def label_probe_auc(acts, labels, l2: float = 1e-2,
                    train_frac: float = 0.7, seed: int = 0) -> float:
    """Held-out AUROC of a linear probe from smashed activations to labels."""
    from repro_torch.train.metrics import auroc
    z = np.asarray(acts, np.float64).reshape(len(acts), -1)
    t = np.asarray(labels, np.float64).reshape(-1, 1)
    tr, te = _split(len(z), train_frac, seed)
    w = _ridge_fit(z[tr], t[tr], l2)
    return auroc(t[te].ravel() > 0.5, _ridge_predict(z[te], w).ravel())


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


@torch.no_grad()
def smashed_activations(adapter, params, batch, transport=None,
                        privacy=None, seed: int = 0) -> np.ndarray:
    """front(batch) as seen by the server: after the wire codec and any
    cut-layer noise (drawn from ``privacy.dpsgd``'s cut stream of ``seed``,
    step 0, hospital 0).  ``batch`` is a dict of tensors on the params'
    device.  Returns a flattened (B, D) float32 matrix."""
    x = adapter.apply_seg("front", params["front"], adapter.inputs(batch),
                          batch, False)
    if transport is not None:
        x = transport.boundary(x)
    if privacy is not None and privacy.cut_noise_std > 0:
        from repro_torch.privacy.dpsgd import (CUT, cut_noise_boundary,
                                               draw_noise, stream_seed)
        first = tree_leaves(x)[0]
        gen = torch.Generator(device=first.device)
        gen.manual_seed(stream_seed(seed, 0, 0, CUT))
        x = cut_noise_boundary(None)(
            x, draw_noise(x, gen, privacy.cut_noise_std))
    leaves = [_host(l).astype(np.float32) for l in tree_leaves(x)]
    b = leaves[0].shape[0]
    return np.concatenate([l.reshape(b, -1) for l in leaves], axis=1)


def measure_leakage(adapter, params, batch, transport=None, privacy=None,
                    seed: int = 0) -> dict:
    """All cut-layer leakage metrics on one evaluation batch."""
    z = smashed_activations(adapter, params, batch, transport, privacy, seed)
    inputs = _host(adapter.inputs(batch))
    labels = _host(batch["label"]) if "label" in batch else None
    out = {
        "dcor_input": distance_correlation(z, inputs),
        "probe": reconstruction_probe(z, inputs, seed=seed),
    }
    if labels is not None and len(np.unique(labels > 0.5)) == 2:
        out["dcor_label"] = distance_correlation(z, labels.reshape(-1, 1))
        out["label_probe_auc"] = label_probe_auc(z, labels, seed=seed)
    return out
