"""Plain PyTorch version of K9 (GroupNorm + ReLU) in ATen's CUDA
arithmetic, which the kernels follow to the bit: per (image, group) row,
512 Welford chains (32 when the row is shorter than 512), chain t over
elements t, t + 512, ... (``RowwiseMomentsCUDAKernel``), each warp's 32
chains combined by ATen's shfl_down tree, the 16 warps' results by one
more, ``rsqrt(M2 / count + eps)``; then ATen's fused ``a * x + b`` and the
ReLU.  Each FMA of the CUDA code (a product added in one rounding) is
taken in float64 and rounded once to f32; ATen's shift ``-a * mean + b``
rounds twice.  The CPU path of the wrapper
runs it; on the card ``chip_smoke.py`` and the tests hold the kernels
against it and against ATen's own ``F.relu(F.group_norm(...))``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

WARP = 32
CHAINS = 512          # ATen's kCUDABlockReduceNumThreads


def chain_count(row_len: int) -> int:
    """ATen's Welford chains a row: 512, or one warp's 32 below 512."""
    return WARP if row_len < CHAINS else CHAINS


def _fma(a, b, c):
    """a * b + c rounded once to f32, as an FMA (the f32 product is exact
    in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _combine(a, b):
    """ATen's ``WelfordOps::combine`` of (mean, m2, count) tensors."""
    (am, a2, an), (bm, b2, bn) = a, b
    delta = bm - am
    count = an + bn
    nb_over_n = bn / count
    out = (_fma(delta, nb_over_n, am), _fma(delta * delta * an, nb_over_n,
                                            a2 + b2), count)
    return tuple(torch.where(an == 0, bv, torch.where(bn == 0, av, ov))
                 for ov, av, bv in zip(out, a, b))


def warp_reduce(v):
    """ATen's ``WarpReduce`` over the last dim (32 lanes): lane i takes
    lane i + offset's value, offsets 16 .. 1; lane 0's result."""
    for off in (16, 8, 4, 2, 1):
        v = _combine(tuple(t[..., :off] for t in v),
                     tuple(t[..., off:2 * off] for t in v))
    return tuple(t[..., 0] for t in v)


def warp_partials_ref(x, groups):
    """(N * G, warps, 3) f32: each warp's (mean, M2, count) of each row's
    chains, x NCHW-contiguous (N, C, H, W)."""
    rows = x.float().reshape(x.shape[0] * groups, -1)
    length = rows.shape[1]
    s = chain_count(length)
    steps = -(-length // s)
    xs = F.pad(rows, (0, steps * s - length)).reshape(len(rows), steps, s)
    mean = torch.zeros((len(rows), s), device=x.device)
    m2, nf = torch.zeros_like(mean), torch.zeros_like(mean)
    lane = torch.arange(s, device=x.device)
    for k in range(steps):                 # ATen's WelfordOps::reduce
        data = xs[:, k]
        new_nf = nf + 1
        delta = data - mean
        new_mean = mean + delta / new_nf
        new = (new_mean, _fma(delta, data - new_mean, m2), new_nf)
        live = lane + k * s < length
        mean, m2, nf = (torch.where(live, a, b)
                        for a, b in zip(new, (mean, m2, nf)))
    w = warp_reduce(tuple(t.reshape(len(rows), s // WARP, WARP)
                          for t in (mean, m2, nf)))
    return torch.stack(w, -1)


def merge_ref(partials, eps):
    """(mean, rstd), each (rows,) f32: ATen's second tree over a row's
    warps (their results in lanes 0 .. warps - 1, empty lanes above),
    then ``rsqrt(M2 / count + eps)``."""
    lanes = torch.zeros((len(partials), WARP, 3), device=partials.device)
    lanes[:, :partials.shape[1]] = partials
    mean, m2, nf = warp_reduce(tuple(lanes[..., i] for i in range(3)))
    return mean, torch.rsqrt(m2 / nf + torch.tensor(
        eps, dtype=torch.float32, device=partials.device))


def apply_ref(x, gamma, beta, mean, rstd, groups):
    """relu(a * x + b) in x's dtype, NCHW-contiguous (ATen's
    ComputeFusedParams and elementwise FMA); mean, rstd: (N, G)."""
    n, c = x.shape[:2]
    cg = c // groups
    scale = (rstd.reshape(n, groups, 1) * gamma.reshape(groups, cg)
             ).reshape(n, c)
    m = mean.reshape(n, groups, 1).expand(n, groups, cg).reshape(n, c)
    shift = -scale * m + beta                     # two roundings, as ATen's
    t = _fma(scale[:, :, None, None], x.float(), shift[:, :, None, None])
    return torch.where(t < 0, 0.0, t).to(x.dtype).contiguous()


def group_norm_relu_ref(x, gamma, beta, groups, eps):
    """x: (N, C, H, W) NCHW-contiguous -> (y, mean (N, G), rstd (N, G))."""
    n = x.shape[0]
    mean, rstd = merge_ref(warp_partials_ref(x, groups), eps)
    mean, rstd = mean.reshape(n, groups), rstd.reshape(n, groups)
    return apply_ref(x, gamma, beta, mean, rstd, groups), mean, rstd
