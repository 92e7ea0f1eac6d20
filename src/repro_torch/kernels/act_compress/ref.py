"""Plain PyTorch versions of the cut-layer int8 codec (K1, K2).

They repeat the kernels' arithmetic op for op: the scale multiplies by the
f32 reciprocal of 127 (as XLA compiles the reference's ``amax / 127``), the
per-element division is a true division by a tensor (never by a Python
scalar, which PyTorch's CUDA division turns into a reciprocal multiply), and
``torch.round`` rounds half to even.  The CPU path of every wrapper runs
these, and ``chip_smoke.py`` holds the kernels against them on the card.
"""

from __future__ import annotations

import torch

INV_127 = float.fromhex("0x1.020408p-7")   # f32(1 / 127), exact in f32
MIN_AMAX = 1e-12


def quantize_ref(x):
    """x: (T, D) float -> (q int8 (T, D), scale f32 (T, 1))."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(MIN_AMAX) * INV_127
    q = torch.clamp(torch.round(torch.div(xf, scale)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_ref(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale).to(dtype)


def roundtrip_ref(x):
    q, s = quantize_ref(x)
    return dequantize_ref(q, s, x.dtype)
