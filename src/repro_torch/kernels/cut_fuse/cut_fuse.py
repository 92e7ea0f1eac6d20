"""K3: the fused cut-layer int8 roundtrip (quantize + dequantize, one pass),
and K4: the same plus the row-weighted cut-layer noise.

Hopper counterparts of ``roundtrip_pallas`` and ``noise_roundtrip_pallas``;
the CUDA source and its design note are in ``kernels/csrc/cut_layer.cu``.
The int8 levels never leave registers.  A CPU tensor takes the plain
version in ``ref.py``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.cut_fuse import ref

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

ROUNDTRIP = B.CudaKernel("cut_layer.cu", "cut_roundtrip", [_P, _P, _N, _I, _I])
NOISE_ROUNDTRIP = B.CudaKernel("cut_layer.cu", "cut_noise_roundtrip",
                               [_P, _P, _P, _P, _N, _I, _I])


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


def noise_roundtrip_rows(x, z, w):
    """x: (T, D) f32/bf16, z: f32 (T, D) pre-scaled noise, w: f32 (T, 1) row
    weights -> ``roundtrip(x) + (z * w).to(x.dtype)``, one pass."""
    if B.on_cpu(x, "noise_roundtrip_rows"):
        return ref.noise_roundtrip_ref(x, z, w)
    B.check_rows(x, B.DTYPE_CODES, "noise_roundtrip_rows")
    B.check_rows(z, (torch.float32,), "noise_roundtrip_rows")
    t, d = x.shape
    if z.shape != x.shape or z.device != x.device:
        raise ValueError("noise_roundtrip_rows: z must match x's shape and "
                         "device")
    if (w.device != x.device or w.dtype != torch.float32
            or tuple(w.shape) != (t, 1) or not w.is_contiguous()):
        raise ValueError("noise_roundtrip_rows: w must be a contiguous f32 "
                         f"(T, 1) tensor on {x.device}")
    out = torch.empty_like(x)
    if t:
        NOISE_ROUNDTRIP(x.data_ptr(), z.data_ptr(), w.data_ptr(),
                        out.data_ptr(), t, d, B.DTYPE_CODES[x.dtype])
    return out
