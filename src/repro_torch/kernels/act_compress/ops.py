"""Shape wrappers + straight-through-estimator roundtrip for training.

``compress_boundary`` is applied at the SL/SFL cut layer: the forward pass
gives the int8-roundtripped activation (what the server receives over the
wire); the backward pass is the identity (STE), as in the reference.
Rows are taken over the LAST axis, so an NHWC activation quantizes all of
its channels at one (b, h, w) position per row.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import straight_through
from repro_torch.kernels.act_compress.act_compress import (dequantize_rows,
                                                           quantize_rows)


def _rows(x):
    return x.reshape(-1, x.shape[-1]).contiguous()


def quantize(x):
    """x: (..., D) -> (int8 same shape, f32 scales (..., 1))."""
    q, s = quantize_rows(_rows(x))
    return q.reshape(x.shape), s.reshape(*x.shape[:-1], 1)


def dequantize(q, s, dtype=torch.bfloat16):
    out = dequantize_rows(_rows(q), s.reshape(-1, 1).contiguous(), dtype)
    return out.reshape(q.shape)


def _roundtrip(x):
    q, s = quantize(x)
    return dequantize(q, s, x.dtype)


compress_boundary = straight_through(_roundtrip)
