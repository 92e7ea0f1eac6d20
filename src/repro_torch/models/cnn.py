"""The paper's DenseNet-121 as an ordered list of *units*, so the cut-layer
split of ``repro_torch.core.partition`` applies directly ("first 4 layers at
the client" == units[0:4]).  Counterpart of ``repro/models/cnn.py``; the
U-Net and the U-shaped split (``nls``) wait for a later slice.

Layouts: a segment takes and returns contiguous NHWC tensors, as the
reference does, so the cut tensor and its int8 rows (one row = all channels
at one (b, h, w) position) are the reference's.  Inside a segment the units
run on the NCHW view of that memory (``torch.channels_last``); ATen's CUDA
GroupNorm returns NCHW-contiguous tensors, so after the first norm a
segment runs in NCHW and leaving it copies once into NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

Unit = tuple[str, Callable, Callable]   # (name, init(gen, device)->p, apply(p, x)->x)


def to_nchw(x):
    """NHWC activation -> its NCHW view (channels_last memory); a 2-D
    tensor (logits) passes through."""
    return x.permute(0, 3, 1, 2) if x.dim() == 4 else x


def to_nhwc(h):
    """NCHW activation -> a contiguous NHWC tensor (a copy unless ``h`` is
    channels_last); a 2-D tensor passes through."""
    return h.permute(0, 2, 3, 1).contiguous() if h.dim() == 4 else h


@dataclasses.dataclass(frozen=True)
class CNNModel:
    name: str
    units: tuple[Unit, ...]
    cut: int                       # units[0:cut] -> client (front)
    seg_names = ("front", "middle")

    @property
    def seg_bounds(self):
        return (0, self.cut), (self.cut, len(self.units))

    def init_params(self, gen: torch.Generator, device: torch.device):
        """Draw every unit's params in unit order from ``gen``."""
        params = {}
        for seg, (lo, hi) in zip(self.seg_names, self.seg_bounds):
            params[seg] = {self.units[i][0]: self.units[i][1](gen, device)
                           for i in range(lo, hi)}
        return params

    def apply_segment(self, seg_params, seg: str, x, train=False):
        lo, hi = dict(zip(self.seg_names, self.seg_bounds))[seg]
        h = to_nchw(x)
        for i in range(lo, hi):
            nm, _, apply_fn = self.units[i]
            h = apply_fn(seg_params[nm], h)
        return to_nhwc(h)

    def apply(self, params, x, train=False):
        for seg in self.seg_names:
            x = self.apply_segment(params[seg], seg, x, train)
        return x


def bce_loss(logits, labels):
    logits = logits.reshape(-1).float()
    labels = labels.reshape(-1).float()
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


# ---------------------------------------------------------------------------
# DenseNet
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DenseNetConfig:
    name: str = "densenet"
    growth: int = 32
    blocks: tuple[int, ...] = (6, 12, 24, 16)     # DenseNet-121
    stem_ch: int = 64
    compression: float = 0.5
    in_ch: int = 1
    n_classes: int = 1
    cut_layer: int = 4           # paper: first 4 layers at the client


def _dense_layer(cfg: DenseNetConfig, in_ch: int):
    """norm-act-conv1x1(4g) + norm-act-conv3x3(g), concat."""
    g = cfg.growth

    def init(gen, device):
        return {"n1": L.groupnorm_init(in_ch, device),
                "c1": L.conv_init(gen, in_ch, 4 * g, 1, device),
                "n2": L.groupnorm_init(4 * g, device),
                "c2": L.conv_init(gen, 4 * g, g, 3, device)}

    def apply(p, x):
        h = F.relu(L.groupnorm_apply(p["n1"], x))
        h = L.conv_apply(p["c1"], h)
        h = F.relu(L.groupnorm_apply(p["n2"], h))
        h = L.conv_apply(p["c2"], h)
        return torch.cat([x, h], dim=1)

    return init, apply


def _transition(cfg: DenseNetConfig, in_ch: int, out_ch: int):
    def init(gen, device):
        return {"n": L.groupnorm_init(in_ch, device),
                "c": L.conv_init(gen, in_ch, out_ch, 1, device)}

    def apply(p, x):
        h = F.relu(L.groupnorm_apply(p["n"], x))
        h = L.conv_apply(p["c"], h)
        return L.avg_pool(h, 2, 2)

    return init, apply


def build_densenet(cfg: DenseNetConfig, cut: int | None = None,
                   nls: bool = False) -> CNNModel:
    """``nls=True`` (the U-shaped split, last unit at the client) is not
    ported yet and raises."""
    if nls:
        raise NotImplementedError("nls=True (the U-shaped split) is not "
                                  "ported yet: ROADMAP M5 (strategies)")
    units: list[Unit] = []

    def stem_init(gen, device):
        return {"c": L.conv_init(gen, cfg.in_ch, cfg.stem_ch, 7, device),
                "n": L.groupnorm_init(cfg.stem_ch, device)}

    def stem_apply(p, x):
        h = L.conv_apply(p["c"], x, stride=2)
        h = F.relu(L.groupnorm_apply(p["n"], h))
        return L.max_pool(h, 3, 2, "SAME")

    units.append(("stem", stem_init, stem_apply))
    ch = cfg.stem_ch
    for bi, n_layers in enumerate(cfg.blocks):
        for li in range(n_layers):
            init, apply = _dense_layer(cfg, ch)
            units.append((f"b{bi}_l{li}", init, apply))
            ch += cfg.growth
        if bi != len(cfg.blocks) - 1:
            out = int(ch * cfg.compression)
            init, apply = _transition(cfg, ch, out)
            units.append((f"t{bi}", init, apply))
            ch = out

    final_ch = ch

    def head_init(gen, device):
        return {"n": L.groupnorm_init(final_ch, device),
                "fc": L.bias_dense_init(gen, final_ch, cfg.n_classes, device)}

    def head_apply(p, x):
        h = F.relu(L.groupnorm_apply(p["n"], x))
        h = L.global_avg_pool(h)
        return L.bias_dense_apply(p["fc"], h)

    units.append(("head", head_init, head_apply))
    return CNNModel(cfg.name, tuple(units),
                    cut=cfg.cut_layer if cut is None else cut)
