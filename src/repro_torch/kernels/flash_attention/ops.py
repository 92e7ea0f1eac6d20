"""The model-layout wrapper of K7 (``repro/kernels/flash_attention/ops.py``):
(B, S, H, D) in and out.  The kernel reads by stride, so the reference's
transposes to (B, H, S, D) become views and nothing is copied."""

from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_bhsd


def flash_attention(q, k, v, causal=True):
    """q: (B, S, H, D); k, v: (B, S, KV, D).  Returns (B, S, H, D)."""
    out = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)
