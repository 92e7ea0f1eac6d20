"""CNN primitives of the paper's model families (the subset of
``repro/models/layers.py`` that DenseNet uses).

Parameters are plain dicts of tensors: conv weights are OIHW (the reference
keeps HWIO; ``repro_torch.interop`` converts), a dense weight is (in, out).
Activations are logically NCHW; a segment's input and output are NHWC in
memory (``models/cnn.py`` says how).  Convolutions, GroupNorm and pools go
to ATen / cuDNN.

Every ``*_init`` draws on the CPU from an explicit ``torch.Generator`` and
then moves the tensor, so one seed gives the same weights on every device;
on the ``meta`` device nothing is drawn (shapes only).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _normal(gen, shape, scale, device, dtype=torch.float32):
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
    return w.to(device=device, dtype=dtype)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of XLA's "SAME" for one spatial dim: at stride 2
    it is asymmetric, e.g. (2, 3) for a 7x7/2 conv on 224 and (0, 1) for a
    3x3/2 pool on 112."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k, s, value=0.0):
    (hl, hh), (wl, wh) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    if hl == hh and wl == wh:
        return x, hl, wl
    return F.pad(x, (wl, wh, hl, hh), value=value), 0, 0


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

def bias_dense_init(gen, in_dim, out_dim, device):
    return {"w": _normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim),
                         device),
            "b": torch.zeros((out_dim,), device=device)}


def bias_dense_apply(p, x):
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


# ---------------------------------------------------------------------------
# norm
# ---------------------------------------------------------------------------

def groupnorm_init(channels, device):
    return {"scale": torch.ones((channels,), device=device),
            "bias": torch.zeros((channels,), device=device)}


def num_groups(c: int, groups: int = 8) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def groupnorm_apply(p, x, groups=8, eps=1e-5):
    """x: (B, C, H, W).  Batch-statistics-free GroupNorm in f32."""
    y = F.group_norm(x.float(), num_groups(x.shape[1], groups),
                     p["scale"].float(), p["bias"].float(), eps)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# conv and pools
# ---------------------------------------------------------------------------

def conv_init(gen, in_ch, out_ch, ksize, device):
    fan_in = in_ch * ksize * ksize
    return {"w": _normal(gen, (out_ch, in_ch, ksize, ksize),
                         math.sqrt(2.0 / fan_in), device)}


def conv_apply(p, x, stride=1):
    """"SAME" convolution (XLA's padding rule) of x: (B, C, H, W)."""
    w = p["w"].to(x.dtype)
    x, ph, pw = _pad_same(x, w.shape[-1], stride)
    return F.conv2d(x, w, stride=stride, padding=(ph, pw))


def avg_pool(x, window=2, stride=2):
    return F.avg_pool2d(x, window, stride)


def max_pool(x, window=2, stride=2, padding="VALID"):
    if padding == "SAME":
        x, ph, pw = _pad_same(x, window, stride, value=-math.inf)
        return F.max_pool2d(x, window, stride, padding=(ph, pw))
    return F.max_pool2d(x, window, stride)


def global_avg_pool(x):
    return x.mean(dim=(2, 3))
