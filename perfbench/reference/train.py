"""Plain PyTorch training of a cut model, whatever its family: the int8
cut-layer link, Adam, an epoch's batches, the SplitFedv3 step and the
validation loss.  Imports nothing of the program.  The model is the
family's (``families/<family>/reference.py`` ``model``): its
``loss_terms(front, middle, batch, link)`` gives a batch's per-example
losses from flat ``{path: tensor}`` dicts, and ``fronts_take_mean`` says
which loss each front's gradient is of (below).

The int8 link quantizes each row (every value along the axis ``dim``: the
channel axis of an NCHW leaf, the width of a token's hidden state) to
levels -127..127 of ``amax / 127``, rounds half to even, and dequantizes;
its gradient passes straight through.  The scale multiplies by f32(1/127),
the same rounding a compiler gives ``amax / 127``.

An epoch (the paper's testbed): each hospital, in order, shuffles its
samples with the run's numpy generator and cuts them into whole batches,
dropping the remainder; the epoch takes as many steps as the most
batches, and a hospital short of batches wraps around to its first.

SplitFedv3 (the paper's Algorithm 1, batch-synchronous): every hospital
runs its own front on its batch, the server runs the middle on what
crossed the link, and the server takes the mean over hospitals of their
gradients; every part has its own Adam state.  Each client takes the
gradient of its own mean loss, or, where the program differentiates the
mean over hospitals of their losses (``fronts_take_mean``), that gradient
over the hospitals' count.  The reference works hospital by hospital, so
it holds one hospital's activations at a time.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

INV_127 = float.fromhex("0x1.020408p-7")     # f32(1 / 127)
MIN_AMAX = 1e-12


class _STE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        amax = x.abs().amax(dim=dim, keepdim=True)
        scale = amax.clamp_min(MIN_AMAX) * INV_127
        q = torch.clamp(torch.round(torch.div(x, scale)), -127, 127)
        return q * scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def int8_link(x, dim: int = 1):
    return _STE.apply(x, dim)


LINKS = {"int8": int8_link, "identity": None}


@contextlib.contextmanager
def precision(tf32: bool):
    """Full float32 (TF32 off) or, for the control, TF32 convolutions and
    matmuls."""
    b = torch.backends
    prev = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = prev


class Adam:
    """Adam (b1 .9, b2 .999, eps 1e-8) over a flat {path: tensor} dict."""

    def __init__(self, params: dict, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            out[k] = p - self.lr * (self.m[k] / bc1) / (
                torch.sqrt(self.v[k] / bc2) + self.eps)
        return out


def hospital_grads(model, front: dict, middle: dict, batch: dict, link,
                   rows=None):
    """One hospital's mean loss and its gradients w.r.t. its front and the
    middle (flat dicts), ``model`` the family's (``loss_terms`` of a
    ``batch`` dict).  ``rows``: the examples the loss averages over (None:
    all; a fault check takes half)."""
    f = {k: v.detach().requires_grad_(True) for k, v in front.items()}
    m = {k: v.detach().requires_grad_(True) for k, v in middle.items()}
    terms = model.loss_terms(f, m, batch, link)
    loss = terms.mean() if rows is None else terms[:rows].mean()
    gf = torch.autograd.grad(loss, list(f.values()) + list(m.values()))
    nf = len(f)
    return (loss.detach(), dict(zip(f, gf[:nf])), dict(zip(m, gf[nf:])))


def epoch_batches(sizes: list, batch: int, rng) -> list:
    """One epoch's steps: each a list of ``(hospital, row indices)``.  Each
    hospital in order shuffles ``arange(n)`` with ``rng`` (numpy's
    ``Generator.shuffle``) and keeps its ``n // batch`` whole batches; step
    s takes each hospital's batch s modulo its count."""
    cut = []
    for n in sizes:
        idx = np.arange(n)
        rng.shuffle(idx)
        nb = n // batch
        cut.append(idx[:nb * batch].reshape(nb, batch))
    steps = max(len(c) for c in cut)
    return [[(h, c[s % len(c)]) for h, c in enumerate(cut)]
            for s in range(steps)]


def train_steps(model, fronts: list, middle: dict, steps: list, lr: float,
                link_name: str = "int8", half: bool = False):
    """SplitFedv3 from ``fronts`` (one flat dict per hospital) and
    ``middle`` through ``steps``, each a list of ``(hospital, batch
    dict)``: every hospital steps its own Adam on its own gradient (over
    the hospitals' count where the model's ``fronts_take_mean``), the
    server its own on the mean over hospitals of theirs.  Returns every
    step's losses in order (a flat numpy array), the first step's
    gradients, the parameters after the last step and the Adam first
    moments after it (each as (fronts, middle)).  ``half`` is a fault:
    each hospital's loss averages over the first half of its rows."""
    link = LINKS[link_name]
    fronts = [dict(f) for f in fronts]
    middle = dict(middle)
    opt_f = [Adam(f, lr) for f in fronts]
    opt_m = Adam(middle, lr)
    first_f, first_m, losses = [{} for _ in fronts], None, []
    for i, step in enumerate(steps, 1):
        gm_sum = None
        for h, batch in step:
            rows = len(next(iter(batch.values()))) // 2 if half else None
            loss, gf, gm = hospital_grads(model, fronts[h], middle, batch,
                                          link, rows)
            losses.append(float(loss))
            if model.fronts_take_mean:
                gf = {k: v / len(step) for k, v in gf.items()}
            if i == 1:
                first_f[h] = {k: v.clone() for k, v in gf.items()}
            fronts[h] = opt_f[h].step(fronts[h], gf)
            gm_sum = gm if gm_sum is None else {
                k: gm_sum[k] + gm[k] for k in gm}
        gm = {k: v / len(step) for k, v in gm_sum.items()}
        if first_m is None:
            first_m = {k: v.clone() for k, v in gm.items()}
        middle = opt_m.step(middle, gm)
    return (np.asarray(losses), (first_f, first_m), (fronts, middle),
            ([o.m for o in opt_f], opt_m.m))


@torch.no_grad()
def val_loss(model, fronts: list, middle: dict, vals: list) -> float:
    """The mean over hospitals of the mean loss of each hospital's
    validation batch (a dict), through its own front and no link."""
    out = []
    for f, batch in zip(fronts, vals):
        out.append(model.loss_terms(f, middle, batch).mean())
    return float(torch.stack(out).mean())
