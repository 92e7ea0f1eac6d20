"""K1 and K2: per-row int8 quantize and dequantize of the cut-layer link.

Hopper counterparts of ``quantize_pallas`` / ``dequantize_pallas``; the CUDA
source and its design note are in ``kernels/csrc/cut_layer.cu``.  A CPU
tensor takes the plain version in ``ref.py``; a CUDA tensor launches the
kernel or raises.

K1 has two paths, and ``quantize_plan`` chooses one from the row width,
the dtype and the pointers, never by a failure: the vector path (a group
of lanes a row, 16-byte loads held in registers, x read once) for rows
that are whole 16-byte vectors on 16-byte boundaries, up to 1,024 f32 or
2,048 bf16 elements; the general path (one warp a row) for the others.
K3 and K4 (``cut_fuse``) share the vector path and its ``vector_plan``.
K2 runs on the same row groups in reverse (each vector's levels in, one
16-byte vector of the output out), on the plan ``dequantize_plan`` gives;
its general path, one warp a row, takes ragged rows and unaligned
pointers.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.act_compress import ref

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

QUANTIZE = B.CudaKernel("cut_layer.cu", "cut_quantize",
                        [_P, _P, _P, _N, _I, _I, _I, _I])
DEQUANTIZE = B.CudaKernel("cut_layer.cu", "cut_dequantize",
                          [_P, _P, _P, _N, _I, _I, _I, _I])

#: the vector path loads rows 16 bytes at a time (K2: writes 16 bytes of
#: its output) and holds at most MAX_VECS such vectors of a row in each
#: lane's registers
VEC_BYTES, MAX_VECS = 16, 8


def vector_plans(d, dtype):
    """Every ``(group, vecs)`` the vector path can take rows of ``d``
    elements of ``dtype`` with: a group of ``group`` lanes (a power of two,
    1 to 32) takes a row, and each lane the fewest vectors that cover it,
    ``vecs``, at most MAX_VECS; empty unless ``d`` is a multiple of the
    vector (4 f32 or 8 bf16)."""
    per = VEC_BYTES // dtype.itemsize
    if d % per:
        return []
    n = d // per
    plans = [(g, -(-n // g)) for g in (1, 2, 4, 8, 16, 32)]
    return [(g, v) for g, v in plans if v <= MAX_VECS]


def vector_plan(d, dtype, aligned):
    """How K1's, K3's and K4's vector path takes rows of ``d`` elements of
    ``dtype``: one of ``vector_plans``, or None for the general path.

    ``aligned``: the kernel's ``(pointer, bytes)`` pairs, each pointer on
    a multiple of its bytes (a pointer to rows of whole vectors on a
    boundary has every row on it).  The vector path needs those.  Of the
    plans, it takes the one with the fewest idle vector slots, then one
    whose groups read whole 32-byte sectors, then about 4 vectors a lane,
    then the wider group.  The plan depends on the pointers: inside a
    captured CUDA graph they stay the same at every replay, so the plan
    taken at capture holds."""
    plans = vector_plans(d, dtype)
    if not plans or any(p % b for p, b in aligned):
        return None
    n = d // (VEC_BYTES // dtype.itemsize)
    return min(plans, key=lambda p: (p[0] * p[1], p[0] < 2 <= n,
                                     abs(p[1] - 4), -p[0]))


def quantize_plan(d, dtype, x_ptr, q_ptr):
    """K1's ``vector_plan`` for rows at ``x_ptr`` into int8 at ``q_ptr``:
    x on a 16-byte boundary, q on the boundary of one vector's levels."""
    per = VEC_BYTES // dtype.itemsize
    return vector_plan(d, dtype, ((x_ptr, VEC_BYTES), (q_ptr, per)))


def dequantize_plan(d, dtype, q_ptr, out_ptr):
    """K2's plan for int8 rows at ``q_ptr`` into rows of ``dtype`` at
    ``out_ptr``: one of ``vector_plans``, or None for the general path.
    It needs out on a 16-byte boundary and q on one vector's levels.

    K2's lanes load narrow vectors of q (a vector's levels, 4 bytes for
    f32 or 8 for bf16), and wide groups serve it better than K1's rule: it
    takes about 2 vectors a lane, then the fewest idle vector slots, then
    the wider group.  Of every plan timed on the card at every width the
    main path hands the link, in f32 and bf16 (``tools/cut_compare.py``),
    this rule took the fastest or one within 2% of it (PERF.md §6, PR
    21).  Like ``vector_plan``, a pure function of the shape, the dtype and
    the pointers."""
    per = VEC_BYTES // dtype.itemsize
    plans = vector_plans(d, dtype)
    if not plans or q_ptr % per or out_ptr % VEC_BYTES:
        return None
    return min(plans, key=lambda p: (abs(p[1] - 2), p[0] * p[1], -p[0]))


def quantize_args(x, q, s):
    """QUANTIZE's arguments for the rows ``x`` into ``q`` and ``s``: the
    pointers, the shape, the dtype code and ``quantize_plan``'s (group,
    vecs), with vecs 0 for the general path."""
    t, d = x.shape
    plan = quantize_plan(d, x.dtype, x.data_ptr(), q.data_ptr())
    return (x.data_ptr(), q.data_ptr(), s.data_ptr(), t, d,
            B.DTYPE_CODES[x.dtype], *(plan or (1, 0)))


def dequantize_args(q, s, out):
    """DEQUANTIZE's arguments for the int8 rows ``q`` and scales ``s`` into
    ``out``: the pointers, the shape, ``out``'s dtype code and
    ``dequantize_plan``'s (group, vecs), with vecs 0 for the general
    path."""
    t, d = q.shape
    plan = dequantize_plan(d, out.dtype, q.data_ptr(), out.data_ptr())
    return (q.data_ptr(), s.data_ptr(), out.data_ptr(), t, d,
            B.DTYPE_CODES[out.dtype], *(plan or (1, 0)))


def quantize_rows(x):
    """x: (T, D) f32/bf16 -> (q int8 (T, D), scale f32 (T, 1))."""
    if B.on_cpu(x, "quantize_rows"):
        return ref.quantize_ref(x)
    B.check_rows(x, B.DTYPE_CODES, "quantize_rows")
    t, d = x.shape
    q = torch.empty((t, d), dtype=torch.int8, device=x.device)
    s = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    if t:
        QUANTIZE(*quantize_args(x, q, s))
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
        DEQUANTIZE(*dequantize_args(q, scale, out))
    return out
