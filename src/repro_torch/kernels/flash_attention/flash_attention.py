"""K7: causal GQA flash attention, forward only.

Hopper counterpart of ``flash_attention_pallas``; the CUDA source and its
design note are in ``kernels/csrc/flash_attention.cu``: f32 runs on
CUDA-core FMAs, bf16 on the tensor cores (P rounded to bf16 before P V,
held to the reference's bf16 bar of 2e-2).  The kernel reads
q, k and v by stride, so any (B, H, S, D) view with a contiguous last axis
will do (the model's (B, S, H, D) tensors, transposed, are such views).  A
CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.flash_attention import ref

_P = ctypes.c_void_p
FLASH = B.CudaKernel("flash_attention.cu", "flash_attention_fwd",
                     [_P, _P, _P, _P, _P, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int])
HEAD_DIMS = (32, 64, 128)      # the kernel's instantiations
BLOCK = 128                    # the reference's block_q / block_k


def check_shapes(q, k, v):
    """Raise where the reference kernel asserts: S_q != S_k, H % KV != 0,
    or S not a multiple of min(128, S)."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash attention: expected q (B, H, S, D) and k, v "
                         f"(B, KV, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] < 1:
        raise ValueError("flash attention: q and k differ in batch or "
                         "head_dim")
    if h % k.shape[1]:
        raise ValueError(f"flash attention: {h} heads not a multiple of "
                         f"{k.shape[1]} kv heads")
    if k.shape[2] != s:
        raise ValueError(f"flash attention: S_q {s} != S_k {k.shape[2]}")
    if s % min(BLOCK, s or 1):
        raise ValueError(f"flash attention: S {s} not a multiple of "
                         f"{BLOCK}")


def check_layout(t, name):
    """Raise unless the kernel can read ``t`` by stride: a contiguous last
    axis, a 16-byte aligned start and other strides that keep every row
    16-byte aligned, multiples of 4 in f32 (float4 loads) and of 8 in bf16
    (16-byte cp.async)."""
    per16 = 16 // t.element_size()
    if t.stride(-1) != 1 or any(st % per16 for st in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError(f"flash attention: {name} needs a contiguous last "
                         f"axis, strides that are multiples of {per16} and "
                         "a 16-byte aligned start")


def flash_attention_bhsd(q, k, v, causal=True):
    """q: (B, H, S, D); k, v: (B, KV, S, D), f32 or bf16 -> (B, H, S, D) in
    q's dtype, laid out as q is."""
    check_shapes(q, k, v)
    if B.on_cpu(q, "flash_attention"):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    b, h, s, d = q.shape
    if q.dtype not in B.DTYPE_CODES or d not in HEAD_DIMS:
        raise ValueError(f"flash attention: no kernel for {q.dtype}, "
                         f"head_dim {d} (head_dim in {HEAD_DIMS})")
    out = torch.empty_like(q)   # q's strides: (B, S, H, D) memory stays so
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out")):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash attention: {name} is {t.dtype} on "
                             f"{t.device}, q {q.dtype} on {q.device}")
        check_layout(t, name)
    if out.numel():
        dims = [b, h, k.shape[1], s, d]
        for t in (q, k, v, out):
            dims += [t.stride(0), t.stride(1), t.stride(2)]
        FLASH(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              (ctypes.c_longlong * len(dims))(*dims),
              1.0 / math.sqrt(d), int(causal), B.DTYPE_CODES[q.dtype])
    return out
