"""The paper's model families, DenseNet-121 and the U-Net (Xception-style
encoder), as ordered lists of *units*, so the cut-layer split of
``repro_torch.core.partition`` applies directly ("first 4 layers at the
client" == units[0:4]).  Counterpart of ``repro/models/cnn.py``.  With
``nls=True`` (the U-shaped, non-label-sharing split) the last unit goes
back to the client as a ``tail`` segment.

A segment boundary may carry a pytree: the U-Net front emits
``(hidden, (skip0, ..., skip3))``, the skip connections crossing the cut.

Layouts: a segment takes and returns contiguous NHWC tensors (every leaf of
its boundary tree), as the reference does, so the cut tensors and their
int8 rows (one row = all channels at one (b, h, w) position) are the
reference's.  Inside a segment the units run on the NCHW view of that
memory (``torch.channels_last``); GroupNorm (K9 on the card, ATen's
elsewhere) returns NCHW-contiguous tensors, so after the first norm a
segment runs in NCHW and leaving it copies each leaf once into NHWC.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.models import layers as L
from repro_torch.tree import tree_map

Unit = tuple[str, Callable, Callable]   # (name, init(gen, device)->p, apply(p, x)->x)


def to_nchw(x):
    """NHWC activation (every leaf of a boundary tree) -> its NCHW view
    (channels_last memory); a 2-D tensor (logits) passes through."""
    return tree_map(lambda t: t.permute(0, 3, 1, 2) if t.dim() == 4 else t,
                    x)


def to_nhwc(h):
    """NCHW activation (every leaf of a tree) -> a contiguous NHWC tensor
    (a copy unless the leaf is channels_last); a 2-D tensor passes
    through."""
    return tree_map(lambda t: t.permute(0, 2, 3, 1).contiguous()
                    if t.dim() == 4 else t, h)


@dataclasses.dataclass(frozen=True)
class CNNModel:
    name: str
    units: tuple[Unit, ...]
    cut: int                       # units[0:cut] -> client (front)
    nls: bool = False              # True: last unit -> client tail

    @property
    def seg_bounds(self):
        n = len(self.units)
        tail_start = n - 1 if self.nls else n
        return (0, self.cut), (self.cut, tail_start), (tail_start, n)

    @property
    def seg_names(self):
        return ("front", "middle", "tail") if self.nls else ("front", "middle")

    def init_params(self, gen: torch.Generator, device: torch.device):
        """Draw every unit's params in unit order from ``gen``."""
        params = {}
        for seg, (lo, hi) in zip(self.seg_names, self.seg_bounds):
            params[seg] = {self.units[i][0]: self.units[i][1](gen, device)
                           for i in range(lo, hi)}
        return params

    def init_axes(self):
        """The logical-axes tree of ``init_params``' params (the
        reference's ``init`` returns it second): each unit's params are
        group norms, (separable) convolutions and the classifier's bias
        dense layer, told apart by their keys; names follow the port's
        OIHW convolution layout."""
        shapes = self.init_params(None, torch.device("meta"))
        return {seg: {nm: {k: _leaf_axes(v) for k, v in unit.items()}
                      for nm, unit in p.items()}
                for seg, p in shapes.items()}

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


def _leaf_axes(p: dict):
    """One CNN layer's axes from its param dict (see ``init_axes``)."""
    if set(p) == {"dw", "pw"}:
        return L.sepconv_axes()
    if set(p) == {"w", "b"}:
        return L.bias_dense_axes(("chan", "classes"))
    if set(p) == {"w"}:
        return L.conv_axes()
    if set(p) == {"scale", "bias"}:
        return L.groupnorm_axes()
    raise KeyError(f"unknown CNN layer params {sorted(p)}")


def bce_terms(logits, labels):
    """Per-example binary cross-entropy of logits, in f32: (B,)."""
    logits = logits.reshape(-1).float()
    labels = labels.reshape(-1).float()
    return (torch.clamp_min(logits, 0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce_loss(logits, labels):
    return torch.mean(bce_terms(logits, labels))


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
        h = L.groupnorm_relu_apply(p["n1"], x)
        h = L.conv_apply(p["c1"], h)
        h = L.groupnorm_relu_apply(p["n2"], h)
        h = L.conv_apply(p["c2"], h)
        return torch.cat([x, h], dim=1)

    return init, apply


def _transition(cfg: DenseNetConfig, in_ch: int, out_ch: int):
    def init(gen, device):
        return {"n": L.groupnorm_init(in_ch, device),
                "c": L.conv_init(gen, in_ch, out_ch, 1, device)}

    def apply(p, x):
        h = L.groupnorm_relu_apply(p["n"], x)
        h = L.conv_apply(p["c"], h)
        return L.avg_pool(h, 2, 2)

    return init, apply


def build_densenet(cfg: DenseNetConfig, cut: int | None = None,
                   nls: bool = False) -> CNNModel:
    units: list[Unit] = []

    def stem_init(gen, device):
        return {"c": L.conv_init(gen, cfg.in_ch, cfg.stem_ch, 7, device),
                "n": L.groupnorm_init(cfg.stem_ch, device)}

    def stem_apply(p, x):
        h = L.conv_apply(p["c"], x, stride=2)
        h = L.groupnorm_relu_apply(p["n"], h)
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
        h = L.groupnorm_relu_apply(p["n"], x)
        h = L.global_avg_pool(h)
        return L.bias_dense_apply(p["fc"], h)

    units.append(("head", head_init, head_apply))
    return CNNModel(cfg.name, tuple(units),
                    cut=cfg.cut_layer if cut is None else cut, nls=nls)


# ---------------------------------------------------------------------------
# U-Net (depthwise-separable / Xception-flavoured encoder)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UNetConfig:
    name: str = "unet"
    widths: tuple[int, ...] = (32, 64, 128, 256)   # encoder pyramid
    in_ch: int = 1
    n_classes: int = 1
    cut_layer: int = 2           # paper: first 6 of a deeper net; scaled here


def _sep_norm_pair(in_ch: int, out_ch: int):
    """Two sepconv-GroupNorm-ReLU layers, the body of every U-Net block."""
    def init(gen, device):
        return {"c1": L.sepconv_init(gen, in_ch, out_ch, 3, device),
                "n1": L.groupnorm_init(out_ch, device),
                "c2": L.sepconv_init(gen, out_ch, out_ch, 3, device),
                "n2": L.groupnorm_init(out_ch, device)}

    def apply(p, x):
        h = L.groupnorm_relu_apply(p["n1"], L.sepconv_apply(p["c1"], x))
        return L.groupnorm_relu_apply(p["n2"], L.sepconv_apply(p["c2"], h))

    return init, apply


def _enc_block(in_ch: int, out_ch: int, down: bool):
    init, body = _sep_norm_pair(in_ch, out_ch)

    def apply(p, state):
        x, skips = state
        h = body(p, x)
        if down:                       # the bottleneck adds no skip
            skips = skips + (h,)
            h = L.max_pool(h, 2, 2)
        return (h, skips)

    return init, apply


def _dec_block(in_ch: int, skip_ch: int, out_ch: int):
    init, body = _sep_norm_pair(in_ch + skip_ch, out_ch)

    def apply(p, state):
        x, skips = state
        x = torch.cat([L.upsample2x(x), skips[-1]], dim=1)
        return (body(p, x), skips[:-1])

    return init, apply


def build_unet(cfg: UNetConfig, cut: int | None = None,
               nls: bool = False) -> CNNModel:
    """Classification-via-segmentation U-Net (paper §3.2): the seg head's
    logit map is pooled into an image-level logit."""
    units: list[Unit] = []

    def lift_apply(p, x):
        return (x, ()) if not isinstance(x, tuple) else x

    units.append(("lift", lambda gen, device: {}, lift_apply))
    chans = [cfg.in_ch] + list(cfg.widths)
    for i, (ci, co) in enumerate(zip(chans[:-1], chans[1:])):
        init, apply = _enc_block(ci, co, down=i != len(cfg.widths) - 1)
        units.append((f"enc{i}", init, apply))
    ws = list(cfg.widths)
    dec_in = ws[-1]
    for i in range(len(ws) - 2, -1, -1):
        init, apply = _dec_block(dec_in, ws[i], ws[i])
        units.append((f"dec{i}", init, apply))
        dec_in = ws[i]
    head_ch = dec_in

    def head_init(gen, device):
        return {"c": L.conv_init(gen, head_ch, cfg.n_classes, 1, device)}

    def head_apply(p, state):
        x, _ = state
        seg = L.conv_apply(p["c"], x)              # (B, 1, H, W) logit map
        # smooth-max pooling -> image-level logit
        return torch.logsumexp(seg.reshape(seg.shape[0], -1), dim=-1,
                               keepdim=True) - math.log(
                                   seg.shape[2] * seg.shape[3])

    units.append(("head", head_init, head_apply))
    return CNNModel(cfg.name, tuple(units),
                    cut=cfg.cut_layer if cut is None else cut, nls=nls)
