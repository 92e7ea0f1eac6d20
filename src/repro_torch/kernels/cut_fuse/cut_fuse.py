"""K3: the fused cut-layer int8 roundtrip (quantize + dequantize, one pass).

Hopper counterpart of ``roundtrip_pallas``; the CUDA source and its design
note are in ``kernels/csrc/cut_layer.cu``.  The int8 levels never leave
registers.  A CPU tensor takes the plain version in ``ref.py``; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.cut_fuse import ref

ROUNDTRIP = B.CudaKernel("cut_layer.cu", "cut_roundtrip",
                         [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_int])


def roundtrip_rows(x):
    """x: (T, D) f32/bf16 -> int8-roundtripped (T, D) of x's dtype."""
    if B.on_cpu(x, "roundtrip_rows"):
        return ref.roundtrip_ref(x)
    B.check_rows(x, B.DTYPE_CODES, "roundtrip_rows")
    t, d = x.shape
    out = torch.empty_like(x)
    if t:
        ROUNDTRIP(x.data_ptr(), out.data_ptr(), t, d, B.DTYPE_CODES[x.dtype])
    return out
