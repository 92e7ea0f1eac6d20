"""K8: Mamba2 SSD's chunk-local compute (intra-chunk output, chunk states,
decay vectors), one launch for every (batch, chunk, head).

Hopper counterpart of ``ssd_chunk_kernel``; the CUDA source and its design
note are in ``kernels/csrc/ssd_scan.cu``.  B and C are read in their own
type (bf16 B/C take the tensor cores for C Bᵀ); every input is read by the
strides of all its axes (the model passes bf16 column slices of its conv
output).  A CPU tensor takes the plain version in ``ref.py``; a CUDA
tensor launches the kernel or raises.
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


def copy_mode(t: torch.Tensor) -> int:
    """How the kernel stages ``t`` (b, nc, q, g or h, n or p): 1 by 16-byte
    copies along its last axis (contiguous), 2 by 16-byte loads down its q
    axis (contiguous: the model's conv output puts the sequence innermost),
    0 by scalar loads.  1 and 2 need every 16-byte piece whole and aligned:
    that axis a whole number of 16 bytes, and the start and every other
    stride (of an axis longer than 1) multiples of 16 bytes."""
    es = t.element_size()

    def aligned(axis):
        return t.data_ptr() % 16 == 0 and all(
            s * es % 16 == 0 for a, (s, d) in enumerate(zip(t.stride(),
                                                            t.shape))
            if a != axis and d > 1)

    for mode, axis in ((1, t.dim() - 1), (2, 2)):
        if t.stride(axis) == 1 and t.shape[axis] * es % 16 == 0 \
                and aligned(axis):
            return mode
    return 0


def kernel_dims(xbar, la, B, C) -> list[int]:
    """The 28 values of the C entry point's ``dims``: the sizes, every
    stride of the four inputs, and the copy modes of B and C (0 unless
    both take the same) and of xbar."""
    b, nc, q, h, p = xbar.shape
    dims = [b, nc, q, h, p, B.shape[3], B.shape[4]]
    for t in (xbar, la, B, C):
        dims += list(t.stride())
    mode = copy_mode(B)
    return dims + [mode if copy_mode(C) == mode else 0, copy_mode(xbar)]


def blocks_per_sm(xbar, la, B, C) -> int:
    """Blocks of the kernel one SM holds at once for these inputs (the
    occupancy the CUDA runtime reports; launches nothing)."""
    dims = kernel_dims(xbar, la, B, C)
    fn = Bld.load(SSD_CHUNK.source).ssd_chunk_blocks_per_sm
    fn.argtypes, fn.restype = [_P, ctypes.c_int], ctypes.c_int
    return fn((ctypes.c_longlong * len(dims))(*dims), Bld.DTYPE_CODES[B.dtype])


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
        dims = kernel_dims(xbar, la, B, C)
        SSD_CHUNK(xbar.data_ptr(), la.data_ptr(), B.data_ptr(), C.data_ptr(),
                  y.data_ptr(), states.data_ptr(), dte.data_ptr(),
                  dfs.data_ptr(), (ctypes.c_longlong * len(dims))(*dims),
                  Bld.DTYPE_CODES[B.dtype])
    return y, states, dte, dfs
