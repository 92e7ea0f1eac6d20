"""Plain PyTorch version of the flash-attention kernel (K7): the
reference's ``flash_attention/ref.py``, f32 softmax, output in q's dtype."""

from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, causal=True):
    """q: (B, H, S, D); k, v: (B, KV, T, D) with H % KV == 0.
    Returns (B, H, S, D)."""
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, s, d).float()
    logits = torch.einsum("bgrsd,bgtd->bgrst", qg, k.float()) / math.sqrt(d)
    if causal:
        mask = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(s, device=q.device)[:, None] + (t - s))
        logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrst,bgtd->bgrsd", w, v.float())
    return out.reshape(b, h, s, d).to(q.dtype)
