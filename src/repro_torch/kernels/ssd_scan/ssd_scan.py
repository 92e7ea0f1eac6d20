"""K8: Mamba2 SSD's chunk-local compute (intra-chunk output, chunk states,
decay vectors), one launch for every (batch, chunk, head).

Hopper counterpart of ``ssd_chunk_kernel``; the CUDA source and its design
note are in ``kernels/csrc/ssd_scan.cu``.  B and C are read in their own
type; every input is read by the strides of all its axes (the model
passes bf16 column slices of its conv output).  A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as Bld
from repro_torch.kernels.ssd_scan import ref

_P = ctypes.c_void_p
SSD_CHUNK = Bld.CudaKernel("ssd_scan.cu", "ssd_chunk_fwd",
                           [_P] * 9 + [ctypes.c_int])
MAX_DIM = 128     # q, n and p: the kernel's tiles and shared memory


def check_kernel_args(xbar, la, B, C):
    """Raise unless the kernel takes these inputs: q, n and p multiples of
    4 up to 128, xbar and la f32, B and C of one type (f32 or bf16), all
    on one device.  Any strides will do."""
    q, p, n = xbar.shape[2], xbar.shape[4], B.shape[4]
    for d, name in ((q, "chunk"), (n, "d_state"), (p, "head_dim")):
        if d > MAX_DIM or d % 4 or d < 4:
            raise ValueError(f"ssd_chunk: no kernel for {name} {d} (a "
                             f"multiple of 4 up to {MAX_DIM})")
    for t, name, dtypes in ((xbar, "xbar", (torch.float32,)),
                            (la, "la", (torch.float32,)),
                            (B, "B", Bld.DTYPE_CODES), (C, "C", (B.dtype,))):
        if t.device != xbar.device or t.dtype not in dtypes:
            raise ValueError(f"ssd_chunk: {name} must be a {dtypes} tensor "
                             f"on {xbar.device}, got {t.dtype} on {t.device}")


def ssd_chunk(xbar, la, B, C):
    """xbar: (b, nc, q, h, p) f32, la: (b, nc, q, h) f32, B, C: (b, nc, q,
    g, n) f32 or bf16.  Returns y_intra (b, nc, q, h, p), states (b, nc, h,
    n, p), dte and dfs (b, nc, q, h), all f32."""
    if xbar.dim() != 5 or la.dim() != 4 or B.dim() != 5 \
            or C.shape != B.shape:
        raise ValueError("ssd_chunk: expected xbar (b,nc,q,h,p), la "
                         "(b,nc,q,h), B and C (b,nc,q,g,n)")
    b, nc, q, h, p = xbar.shape
    g, n = B.shape[3], B.shape[4]
    if tuple(la.shape) != (b, nc, q, h) or tuple(B.shape[:3]) != (b, nc, q) \
            or g < 1 or h % g:
        raise ValueError(f"ssd_chunk: shapes {tuple(xbar.shape)}, "
                         f"{tuple(la.shape)}, {tuple(B.shape)} disagree")
    if Bld.on_cpu(xbar, "ssd_chunk"):
        return ref.ssd_chunk_ref(xbar, la, B, C)
    check_kernel_args(xbar, la, B, C)
    f32 = dict(dtype=torch.float32, device=xbar.device)
    y = torch.empty((b, nc, q, h, p), **f32)
    states = torch.empty((b, nc, h, n, p), **f32)
    dte = torch.empty((b, nc, q, h), **f32)
    dfs = torch.empty((b, nc, q, h), **f32)
    if y.numel() or states.numel():
        dims = [b, nc, q, h, p, g, n]
        for t in (xbar, la, B, C):
            dims += list(t.stride())
        SSD_CHUNK(xbar.data_ptr(), la.data_ptr(), B.data_ptr(), C.data_ptr(),
                  y.data_ptr(), states.data_ptr(), dte.data_ptr(),
                  dfs.data_ptr(), (ctypes.c_longlong * len(dims))(*dims),
                  Bld.DTYPE_CODES[B.dtype])
    return y, states, dte, dfs
