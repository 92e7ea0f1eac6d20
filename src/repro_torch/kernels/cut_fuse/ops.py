"""Shape wrapper + STE for the fused cut-layer kernel.

``roundtrip_boundary`` is the fused drop-in for
``act_compress.ops.compress_boundary``: one launch instead of a quantize +
dequantize pair, bit-equal to it, straight-through in the backward pass.
"""

from __future__ import annotations

from repro_torch.kernels import straight_through
from repro_torch.kernels.cut_fuse.cut_fuse import roundtrip_rows


def fused_roundtrip(x):
    """Per-row (last axis) absmax int8 quantize+dequantize in one kernel."""
    out = roundtrip_rows(x.reshape(-1, x.shape[-1]).contiguous())
    return out.reshape(x.shape)


roundtrip_boundary = straight_through(fused_roundtrip)
