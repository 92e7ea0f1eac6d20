"""LR schedules, including WSD (warmup-stable-decay) from MiniCPM
[arXiv:2404.06395] — counterpart of ``repro/optim/schedules.py``.

Each schedule maps a step count to an f32 rate with tensor operations only
(``torch.where``, ``torch.clamp``): given Adam's device step count it runs
on the card inside a captured step, so every replay takes its own step's
rate.  Python ints and floats are taken too.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=getattr(step, "device", None))


def cosine_warmup(peak: float, warmup: int, total: int, floor: float = 0.0):
    def fn(step):
        step = _f32(step)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return fn


def wsd(peak: float, warmup: int, stable: int, decay: int,
        floor_frac: float = 0.1):
    """Warmup -> Stable (constant) -> exponential Decay (MiniCPM §4)."""
    floor = peak * floor_frac

    def fn(step):
        step = _f32(step)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup - stable) / max(decay, 1), 0, 1)
        dec = peak * torch.pow(torch.full_like(frac, floor / peak), frac)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable,
                                       torch.full_like(step, peak), dec))
    return fn
