"""Plain PyTorch training of the cut model: the int8 cut-layer link, Adam,
an epoch's batches, the SplitFedv3 step, the validation loss, and the FLOP
and byte counts the roofline metrics divide by.  Imports nothing of the
program.

The int8 link quantizes each row (every channel at one position of an
NCHW leaf, the channel axis) to levels -127..127 of ``amax / 127``, rounds
half to even, and dequantizes; its gradient passes straight through.  The
scale multiplies by f32(1/127), the same rounding a compiler gives
``amax / 127``.

An epoch (the paper's testbed): each hospital, in order, shuffles its
images with the run's numpy generator and cuts them into whole batches,
dropping the remainder; the epoch takes as many steps as the most
batches, and a hospital short of batches wraps around to its first.

SplitFedv3 (the paper's Algorithm 1, batch-synchronous): every hospital
runs its own front on its batch, the server runs the middle on what
crossed the link, each client takes the gradient of its own mean loss and
the server the mean over hospitals of theirs; every part has its own Adam
state.  The reference works hospital by hospital (GroupNorm and the link
act per example and per row), so it holds one hospital's activations at a
time.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference.cnn import Model, bce, leaves, map_leaves, nest

INV_127 = float.fromhex("0x1.020408p-7")     # f32(1 / 127)
MIN_AMAX = 1e-12


class _STE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.abs().amax(dim=1, keepdim=True)
        scale = amax.clamp_min(MIN_AMAX) * INV_127
        q = torch.clamp(torch.round(torch.div(x, scale)), -127, 127)
        return q * scale

    @staticmethod
    def backward(ctx, g):
        return g


def int8_link(x):
    return _STE.apply(x)


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


def to_nchw(image):
    """A batch of NHWC images (the data's layout) -> NCHW."""
    return image.permute(0, 3, 1, 2)


def hospital_grads(model: Model, front: dict, middle: dict, image, label,
                   link, rows=None):
    """One hospital's mean loss and its gradients w.r.t. its front and the
    middle (flat dicts).  ``rows``: the examples the loss averages over
    (None: all; a fault check takes half)."""
    f = {k: v.detach().requires_grad_(True) for k, v in front.items()}
    m = {k: v.detach().requires_grad_(True) for k, v in middle.items()}
    terms = model.loss_terms(nest(f), nest(m), to_nchw(image), label, link)
    loss = terms.mean() if rows is None else terms[:rows].mean()
    gf = torch.autograd.grad(loss, list(f.values()) + list(m.values()))
    nf = len(f)
    return (loss.detach(), dict(zip(f, gf[:nf])), dict(zip(m, gf[nf:])))


def epoch_batches(n_images: list, batch: int, rng) -> list:
    """One epoch's steps: each a list of ``(hospital, row indices)``.  Each
    hospital in order shuffles ``arange(n)`` with ``rng`` (numpy's
    ``Generator.shuffle``) and keeps its ``n // batch`` whole batches; step
    s takes each hospital's batch s modulo its count."""
    cut = []
    for n in n_images:
        idx = np.arange(n)
        rng.shuffle(idx)
        nb = n // batch
        cut.append(idx[:nb * batch].reshape(nb, batch))
    steps = max(len(c) for c in cut)
    return [[(h, c[s % len(c)]) for h, c in enumerate(cut)]
            for s in range(steps)]


def train_steps(model: Model, fronts: list, middle: dict, steps: list,
                lr: float, link_name: str = "int8", half: bool = False):
    """SplitFedv3 from ``fronts`` (one flat dict per hospital) and
    ``middle`` through ``steps``, each a list of ``(hospital, image NHWC,
    label)``: every hospital steps its own Adam on its own gradient, the
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
        for h, image, label in step:
            rows = len(label) // 2 if half else None
            loss, gf, gm = hospital_grads(model, fronts[h], middle, image,
                                          label, link, rows)
            losses.append(float(loss))
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
def val_loss(model: Model, fronts: list, middle: dict, vals: list) -> float:
    """The mean over hospitals of the mean loss of each hospital's
    validation images, through its own front and no link."""
    out = []
    for f, (image, label) in zip(fronts, vals):
        out.append(model.loss_terms(nest(f), nest(middle), to_nchw(image),
                                    label).mean())
    return float(torch.stack(out).mean())


def forward_flops(cfg: dict) -> int:
    """FLOPs of one image's forward pass through the whole model, counted
    by ``FlopCounterMode`` on ``meta`` tensors (a multiply-add counts 2)."""
    model = Model(cfg)
    meta = torch.device("meta")
    params = {seg: nest({p: torch.empty(s, device=meta)
                         for p, s, _, _ in model.param_specs(seg)})
              for seg in ("front", "middle")}
    size, ch = cfg["image_size"], cfg["model"]["in_ch"]
    x = torch.empty((1, ch, size, size), device=meta)
    with FlopCounterMode(display=False) as fc:
        model.apply("middle", params["middle"],
                    model.apply("front", params["front"], x))
    return int(fc.get_total_flops())


def boundary_shapes(cfg: dict, batch: int) -> list:
    """Shapes (NCHW) of the boundary leaves for ``batch`` images."""
    model = Model(cfg)
    meta = torch.device("meta")
    front = nest({p: torch.empty(s, device=meta)
                  for p, s, _, _ in model.param_specs("front")})
    size, ch = cfg["image_size"], cfg["model"]["in_ch"]
    h = model.apply("front", front,
                    torch.empty((batch, ch, size, size), device=meta))
    return [tuple(t.shape) for t in leaves(h)]


ITEMSIZE = {"fp32": 4, "bf16": 2}


def link_bytes(cfg: dict, batch: int) -> int:
    """Bytes the fused int8 roundtrip (K3) must move for one crossing of
    ``batch`` images: every boundary element, in the configuration's
    precision, read once and written once."""
    n = 0
    for s in boundary_shapes(cfg, batch):
        k = 1
        for d in s:
            k *= d
        n += k
    return 2 * n * ITEMSIZE[cfg["precision"]]
