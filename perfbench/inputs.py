"""What a run feeds both sides, made from ``--seed`` on the device: the
hospitals' synthetic chest X-rays and the model's initial weights.

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

import numpy as np
import torch

from perfbench.reference.cnn import Model

MAX_BLOBS = 4
# the generators' seeds: a run's seed plus a fixed offset for each stream
DATA_STREAM, WEIGHT_STREAM = 0x5EED_DA7A, 0x5EED_3E16


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) + stream) % 2 ** 63)


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


def hospitals(seed: int, traffic: dict, size: int, device) -> list:
    """One namespace per hospital with ``train`` and ``val`` dicts of numpy
    arrays ({"image": (N, size, size, 1) f32, "label": (N,) f32}), the
    layout the program's strategies read."""
    gen = generator(seed, DATA_STREAM, device)
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


def weights(seed: int, model: Model, n_hospitals: int, device) -> tuple:
    """Initial weights: each hospital's own front and one middle, as flat
    {path: tensor} dicts, drawn in one call: convolutions N(0, 2 / fan_in),
    dense layers N(0, 1 / fan_in), norms' scales 1 and biases 0."""
    specs = {s: model.param_specs(s) for s in ("front", "middle")}
    parts = [("front", h) for h in range(n_hospitals)] + [("middle", None)]
    numel = {s: sum(int(np.prod(sh)) for _, sh, kind, _ in sp
                    if kind in ("conv", "dense"))
             for s, sp in specs.items()}
    total = sum(numel[s] for s, _ in parts)
    flat = torch.randn(total, generator=generator(seed, WEIGHT_STREAM, device),
                       device=device)
    out, off = [], 0
    for seg, _ in parts:
        d = {}
        for path, shape, kind, fan in specs[seg]:
            if kind == "one":
                d[path] = torch.ones(shape, device=device)
            elif kind == "zero":
                d[path] = torch.zeros(shape, device=device)
            else:
                n = int(np.prod(shape))
                std = (2.0 if kind == "conv" else 1.0) / fan
                d[path] = flat[off:off + n].view(shape) * std ** 0.5
                off += n
        out.append(d)
    return out[:-1], out[-1]
