"""Plain PyTorch versions of the DP-SGD clip kernels (K5, K6), and the clip
factor ``clip_accumulate`` takes between them.  The CPU path of every
wrapper runs these, and ``chip_smoke.py`` holds the kernels against them on
the card."""

from __future__ import annotations

import math

import torch


def sqnorms_ref(g):
    """g: (B, D) -> (B, 1) f32 per-example sums of squares."""
    g = g.float()
    return (g * g).sum(-1, keepdim=True)


def scale_accum_ref(g, scales):
    """g: (B, D), scales: (B, 1) -> (1, D) f32 of sum_b scales[b] * g[b]."""
    return (g.float() * scales).sum(0, keepdim=True)


def clip_scales(sq_norms, clip_norm):
    """min(1, C / ||g||) from per-example squared norms; C = inf -> ones."""
    norms = torch.sqrt(sq_norms.clamp_min(0.0))
    if not math.isfinite(clip_norm):
        return torch.ones_like(norms)
    return torch.clamp_max(clip_norm / norms.clamp_min(1e-12), 1.0)
