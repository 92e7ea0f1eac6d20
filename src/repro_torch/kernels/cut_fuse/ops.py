"""Shape wrappers + straight-through backward for the fused cut-layer
kernels.

``roundtrip_boundary`` is the fused drop-in for
``act_compress.ops.compress_boundary``: one launch instead of a quantize +
dequantize pair, bit-equal to it, straight-through in the backward pass.
``cut_noise_roundtrip`` adds the cut-layer noise in the same launch (K4).
Its gradient goes to ``x`` unchanged; the noise gets none (it comes from a
generator).  Under ``torch.func.vmap`` (per-example DP-SGD gradients) both
launch once for all examples together.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import straight_through
from repro_torch.kernels.cut_fuse.cut_fuse import (noise_roundtrip_rows,
                                                   roundtrip_rows)


def fused_roundtrip(x):
    """Per-row (last axis) absmax int8 quantize+dequantize in one kernel."""
    out = roundtrip_rows(x.reshape(-1, x.shape[-1]).contiguous())
    return out.reshape(x.shape)


roundtrip_boundary = straight_through(fused_roundtrip)


def _noise_roundtrip(x, z):
    """K4 over the rows of x (B, ..., D): ``roundtrip(x) + z.to(x.dtype)``,
    z the pre-scaled f32 noise of x's shape (``dpsgd.draw_cut_noise``).
    Every row is weighted 1: the stepwise engine has no padding rows."""
    d = x.shape[-1]
    rows = x.reshape(-1, d).contiguous()
    w = torch.ones((rows.shape[0], 1), dtype=torch.float32, device=x.device)
    return noise_roundtrip_rows(rows, z.reshape(-1, d).contiguous(),
                                w).reshape(x.shape)


cut_noise_roundtrip = straight_through(_noise_roundtrip)
