"""What the CNN families (``families/densenet``, ``families/unet``) share
on the reference's side: the hospitals' synthetic chest X-rays, the
initial weights, a batch's loss terms through ``reference/cnn.py``'s
model, and its FLOP and byte counts.  Each function takes the family's
``units`` (``reference/cnn.py``'s ``densenet_units`` or ``unet_units``).
Imports nothing of the program.

The images follow the recipe of the program's ``make_cxr_clients`` (kept
here so the yardstick cannot move): a smooth background (noise at 1/8 of
the size, upsampled 8x8, plus fine noise), one to four Gaussian blobs on
each positive image, a scanner shift per hospital (gain, offset, lesion
polarity and intensity, a spatial prior), then tanh.  Training sets are
half positive, validation sets 10%, as in the paper.  Drawn with one
``torch.Generator`` on the card in a few large calls, not with numpy.
"""

from __future__ import annotations

import types

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import inputs
from perfbench.reference.cnn import Model, leaves, nest

MAX_BLOBS = 4
ITEMSIZE = {"fp32": 4, "bf16": 2}


# -- the hospitals' images -------------------------------------------------------

def _uniform(gen, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)


def _split(gen, n, size, prevalence, shift, device):
    """n images (N, size, size, 1) and labels (N,) of one hospital."""
    labels = (torch.rand(n, generator=gen, device=device)
              < prevalence).float()
    low = torch.randn((n, size // 8, size // 8), generator=gen, device=device)
    img = low.repeat_interleave(8, 1).repeat_interleave(8, 2)
    img = img + shift["noise"] * torch.randn((n, size, size), generator=gen,
                                             device=device)
    k = torch.randint(1, MAX_BLOBS + 1, (n, 1), generator=gen, device=device)
    on = (torch.arange(MAX_BLOBS, device=device) < k).float()   # (n, 4)
    cx = (shift["center"][0] + 0.2 * torch.randn(
        (n, MAX_BLOBS), generator=gen, device=device)).clamp(0.1, 0.9) * size
    cy = (shift["center"][1] + 0.2 * torch.randn(
        (n, MAX_BLOBS), generator=gen, device=device)).clamp(0.1, 0.9) * size
    r = size * _uniform(gen, (n, MAX_BLOBS), 0.08, 0.18, device)
    grid = torch.arange(size, dtype=torch.float32, device=device)
    w = (on * labels[:, None] * shift["intensity"])               # (n, 4)
    for b in range(MAX_BLOBS):     # one (n, size, size) plane at a time
        dx = (grid[None, None, :] - cx[:, b, None, None]) ** 2
        dy = (grid[None, :, None] - cy[:, b, None, None]) ** 2
        img += w[:, b, None, None] * torch.exp(
            -(dx + dy) / (2 * r[:, b, None, None] ** 2))
    img = torch.tanh(shift["gain"] * img + shift["offset"])
    return img[..., None], labels


def hospitals(seed: int, cfg: dict, traffic: dict, device) -> list:
    """One namespace per hospital with ``train`` and ``val`` dicts of numpy
    arrays ({"image": (N, size, size, 1) f32, "label": (N,) f32}), the
    layout the program's strategies read; ``size`` is ``cfg``'s
    ``image_size``, the volumes ``traffic``'s ``train_images`` and
    ``val_images``."""
    size = cfg["image_size"]
    gen = inputs.generator(seed, inputs.DATA_STREAM, device)
    out = []
    for h, n_train in enumerate(traffic["train_images"]):
        u = torch.rand(7, generator=gen, device=device).tolist()
        shift = {"noise": 0.08 + 0.22 * u[0], "gain": 0.5 + u[1],
                 "offset": -0.4 + 0.8 * u[2],
                 "intensity": (1.0 if h % 2 == 0 else -1.0) * (2.0 + 1.5 * u[3]),
                 "center": (0.25 + 0.5 * u[4], 0.25 + 0.5 * u[5])}
        parts = {}
        for name, n, prev in (("train", n_train, 0.5),
                              ("val", traffic["val_images"], 0.1)):
            img, lab = _split(gen, n, size, prev, shift, device)
            parts[name] = {"image": img.cpu().numpy(),
                           "label": lab.cpu().numpy()}
        out.append(types.SimpleNamespace(name=f"H{h + 1}", **parts))
    return out


# -- weights, loss, counts ---------------------------------------------------------

def weights(units, seed: int, cfg: dict, n_hospitals: int, device) -> tuple:
    """Initial weights: each hospital's own front and one middle, as flat
    {path: tensor} dicts, drawn in one call: convolutions N(0, 2 / fan_in),
    dense layers N(0, 1 / fan_in), norms' scales 1 and biases 0."""
    model = Model(cfg, units)

    def specs(seg):
        return [(path, shape, kind, None) if kind in ("one", "zero") else
                (path, shape, "normal", (2.0 if kind == "conv" else 1.0) / fan)
                for path, shape, kind, fan in model.param_specs(seg)]
    out = inputs.draw(seed, [specs("front")] * n_hospitals + [specs("middle")],
                      device)
    return out[:-1], out[-1]


def to_nchw(image):
    """A batch of NHWC images (the data's layout) -> NCHW."""
    return image.permute(0, 3, 1, 2)


class Loss:
    """A batch's per-image losses from flat {path: tensor} dicts: the
    front, the cut link on every boundary leaf's channel axis, the middle,
    binary cross-entropy.  Each front's gradient is of its own hospital's
    mean loss (``fronts_take_mean`` False), as the strategies take it."""

    fronts_take_mean = False

    def __init__(self, units, cfg: dict):
        self.model = Model(cfg, units)

    def loss_terms(self, front, middle, batch, link=None):
        return self.model.loss_terms(nest(front), nest(middle),
                                     to_nchw(batch["image"]), batch["label"],
                                     link)


def _meta_params(model: Model, seg: str) -> dict:
    meta = torch.device("meta")
    return nest({p: torch.empty(s, device=meta)
                 for p, s, _, _ in model.param_specs(seg)})


def forward_flops(units, cfg: dict) -> int:
    """FLOPs of one image's forward pass through the whole model, counted
    by ``FlopCounterMode`` on ``meta`` tensors (a multiply-add counts 2)."""
    model = Model(cfg, units)
    size, ch = cfg["image_size"], cfg["model"]["in_ch"]
    x = torch.empty((1, ch, size, size), device=torch.device("meta"))
    with FlopCounterMode(display=False) as fc:
        model.apply("middle", _meta_params(model, "middle"),
                    model.apply("front", _meta_params(model, "front"), x))
    return int(fc.get_total_flops())


def boundary_shapes(units, cfg: dict, batch: int) -> list:
    """Shapes (NCHW) of the boundary leaves for ``batch`` images."""
    model = Model(cfg, units)
    size, ch = cfg["image_size"], cfg["model"]["in_ch"]
    h = model.apply("front", _meta_params(model, "front"),
                    torch.empty((batch, ch, size, size),
                                device=torch.device("meta")))
    return [tuple(t.shape) for t in leaves(h)]


def link_bytes(units, cfg: dict, batch: int) -> int:
    """Bytes the fused int8 roundtrip (K3) must move for one crossing of
    ``batch`` images: every boundary element, in the configuration's
    precision, read once and written once."""
    n = 0
    for s in boundary_shapes(units, cfg, batch):
        k = 1
        for d in s:
            k *= d
        n += k
    return 2 * n * ITEMSIZE[cfg["precision"]]

