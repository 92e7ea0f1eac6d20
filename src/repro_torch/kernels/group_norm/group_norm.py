"""K9: GroupNorm fused with the ReLU after it, two launches a call (three
for a channels_last input).

The CUDA source and its design note are in ``kernels/csrc/group_norm.cu``:
ATen's arithmetic to the bit (its 512 Welford chains a row and their
combine trees, ``rsqrtf``, its fused ``a * x + b``), with a row's 16 warps
of chains spread over the card as 16 blocks, each chain keeping loads in
flight, and the apply writing ``relu(GroupNorm(x))``.  x is read
NCHW-contiguous: a channels_last x (the segments' first norm) is copied
first by ``to_nchw``, as ATen's CUDA GroupNorm copies it.  CUDA tensors
launch the kernels or raise.  CPU tensors take the plain version in
``ref.py``: only the tests come that way, since the model's CPU route,
``layers.groupnorm_relu_apply``, runs ATen's pair and never calls K9.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.group_norm import ref

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float

STATS = B.CudaKernel("group_norm.cu", "group_norm_relu_stats",
                     [_P, _I, _L, _I, _L, _I, _P])
APPLY = B.CudaKernel("group_norm.cu", "group_norm_relu_apply",
                     [_P, _P, _P, _P, _I, _L, _I, _L, _I, _F, _P, _P, _P])
TO_NCHW = B.CudaKernel("group_norm.cu", "group_norm_to_nchw",
                       [_P, _I, _L, _I, _L, _P])


def to_nchw(x):
    """x (N, C, H, W) NCHW-contiguous: itself if it is, a copy otherwise
    (a channels_last CUDA tensor by the tiled kernel, any other layout, or
    a CPU tensor, by ``Tensor.contiguous``)."""
    if x.is_contiguous():
        return x
    if B.on_cpu(x, "group_norm_relu") or x.dtype not in B.DTYPE_CODES \
            or not x.is_contiguous(memory_format=torch.channels_last):
        return x.contiguous()
    n, c, h, w = x.shape
    out = torch.empty((n, c, h, w), dtype=x.dtype, device=x.device)
    TO_NCHW(x.data_ptr(), B.DTYPE_CODES[x.dtype], n, c, h * w,
            out.data_ptr())
    return out


def group_norm_relu_fwd(x, gamma, beta, groups: int, eps: float):
    """x: (N, C, H, W) f32 or bf16; gamma, beta: (C,) f32 -> (y, mean,
    rstd): y = relu(GroupNorm(x)) NCHW-contiguous in x's dtype, mean and
    rstd (N, G) f32 (what ``aten.native_group_norm_backward`` takes)."""
    if x.dim() != 4 or x.shape[1] % groups:
        raise ValueError(f"group_norm_relu: expected (N, C, H, W) with C a "
                         f"multiple of {groups}, got {tuple(x.shape)}")
    n, c, h, w = x.shape
    x = to_nchw(x)
    if B.on_cpu(x, "group_norm_relu"):
        return ref.group_norm_relu_ref(x, gamma, beta, groups, eps)
    if x.dtype not in B.DTYPE_CODES:
        raise TypeError(f"group_norm_relu: dtype {x.dtype} not in "
                        f"{tuple(B.DTYPE_CODES)}")
    if not x.numel():
        raise ValueError("group_norm_relu: empty input")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if (t.device != x.device or t.dtype != torch.float32
                or t.shape != (c,) or not t.is_contiguous()):
            raise ValueError(f"group_norm_relu: {name} must be ({c},) "
                             f"contiguous f32 on {x.device}")
    warps = ref.chain_count(c // groups * h * w) // ref.WARP
    partials = torch.empty((n * groups * warps * 3,), dtype=torch.float32,
                           device=x.device)
    y = torch.empty((n, c, h, w), dtype=x.dtype, device=x.device)
    mean = torch.empty((n, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    code = B.DTYPE_CODES[x.dtype]
    STATS(x.data_ptr(), code, n, c, h * w, groups, partials.data_ptr())
    APPLY(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
          partials.data_ptr(), code, n, c, h * w, groups, eps, y.data_ptr(),
          mean.data_ptr(), rstd.data_ptr())
    return y, mean, rstd
