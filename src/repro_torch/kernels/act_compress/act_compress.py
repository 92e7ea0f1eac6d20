"""K1 and K2: per-row int8 quantize and dequantize of the cut-layer link.

Hopper counterparts of ``quantize_pallas`` / ``dequantize_pallas``; the CUDA
source and its design note are in ``kernels/csrc/cut_layer.cu``.  A CPU
tensor takes the plain version in ``ref.py``; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.act_compress import ref

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

QUANTIZE = B.CudaKernel("cut_layer.cu", "cut_quantize",
                        [_P, _P, _P, _N, _I, _I])
DEQUANTIZE = B.CudaKernel("cut_layer.cu", "cut_dequantize",
                          [_P, _P, _P, _N, _I, _I])


def quantize_rows(x):
    """x: (T, D) f32/bf16 -> (q int8 (T, D), scale f32 (T, 1))."""
    if B.on_cpu(x, "quantize_rows"):
        return ref.quantize_ref(x)
    B.check_rows(x, B.DTYPE_CODES, "quantize_rows")
    t, d = x.shape
    q = torch.empty((t, d), dtype=torch.int8, device=x.device)
    s = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    if t:
        QUANTIZE(x.data_ptr(), q.data_ptr(), s.data_ptr(), t, d,
                 B.DTYPE_CODES[x.dtype])
    return q, s


def dequantize_rows(q, scale, dtype=torch.bfloat16):
    """q: int8 (T, D), scale: f32 (T, 1) -> (T, D) ``dtype``."""
    if B.on_cpu(q, "dequantize_rows"):
        return ref.dequantize_ref(q, scale, dtype)
    B.check_rows(q, (torch.int8,), "dequantize_rows")
    t, d = q.shape
    if (scale.device != q.device or scale.dtype != torch.float32
            or tuple(scale.shape) != (t, 1) or not scale.is_contiguous()):
        raise ValueError("dequantize_rows: scale must be a contiguous f32 "
                         f"(T, 1) tensor on {q.device}")
    if dtype not in B.DTYPE_CODES:
        raise TypeError(f"dequantize_rows: no kernel for output {dtype}")
    out = torch.empty((t, d), dtype=dtype, device=q.device)
    if t:
        DEQUANTIZE(q.data_ptr(), scale.data_ptr(), out.data_ptr(), t, d,
                   B.DTYPE_CODES[dtype])
    return out
