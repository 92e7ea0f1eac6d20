"""Mixture-of-Experts layer (GShard-style capacity dispatch), the port of
``repro/models/moe.py``.

* top-k routing with a fixed per-expert capacity, expressed as dense
  one-hot products (``torch.einsum``), as in the reference: no hand kernel;
* tokens are dispatched in fixed-size chunks, so the (chunk, E, cap)
  one-hot stays small on trillion-param configs; the reference scans the
  chunks, the port stacks them on a leading axis and dispatches them in
  one batch of products;
* aux losses: load balance (Switch) and router z-loss, each a mean over a
  chunk's (padded) tokens, then a mean over chunks; ``dropped`` is the
  share of (token, slot) pairs past their expert's capacity.

Routing follows ``jax.lax.top_k``: ties between equal probabilities go to
the lower expert index (a zero padding row ties every expert), which
``torch.sort(stable=True)`` keeps and ``torch.topk`` does not promise.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int               # per-expert hidden dim
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    chunk: int = 1024       # tokens per dispatch chunk
    n_shared_experts: int = 0   # dense "shared expert" (DeepSeek/Kimi style)


def moe_init(gen, cfg: MoEConfig, device):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = 1.0 / math.sqrt(d)
    p = {"router": L._normal(gen, (d, e), s, device),
         "wi": L._normal(gen, (e, d, f), s, device),
         "wg": L._normal(gen, (e, d, f), s, device),
         "wo": L._normal(gen, (e, f, d), 1.0 / math.sqrt(f), device)}
    if cfg.n_shared_experts:
        p["shared"] = L.swiglu_init(gen, d, f * cfg.n_shared_experts, device)
    return p


def moe_axes(cfg: MoEConfig):
    """``moe_init``'s logical axes."""
    a = {"router": ("embed", "experts_r"),
         "wi": ("experts", "embed", "ff"),
         "wg": ("experts", "embed", "ff"),
         "wo": ("experts", "ff", "embed")}
    if cfg.n_shared_experts:
        a["shared"] = L.swiglu_axes()
    return a


def capacity(chunk_tokens: int, cfg: MoEConfig) -> int:
    cap = int(math.ceil(chunk_tokens * cfg.top_k / cfg.n_experts
                        * cfg.capacity_factor))
    return max(cap, 1)


def top_k_lower_index(probs, k: int):
    """(values, indices) of the ``k`` largest along the last axis, in
    descending order, ties toward the lower index (``jax.lax.top_k``)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(probs, -1, idx), idx


def _dispatch(p, cfg: MoEConfig, x):
    """x: (N, T, D), N chunks of T tokens.  Returns (y (N, T, D), aux of
    per-chunk (N,) values)."""
    n, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(t, cfg)

    logits = x.float() @ p["router"].float()                   # (N, T, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k_lower_index(probs, k)                   # (N, T, k)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)

    onehot = F.one_hot(topi, e).float()                        # (N, T, k, E)
    # position of each (token, slot) within its expert queue, token-major
    flat = onehot.reshape(n, t * k, e)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = (pos * flat).sum(-1).reshape(n, t, k).long()         # (N, T, k)
    in_cap = pos < cap
    pos_oh = (F.one_hot(torch.clamp_max(pos, cap - 1), cap).float()
              * in_cap[..., None])
    dispatch = torch.einsum("ntke,ntkc->ntec", onehot, pos_oh)
    combine = torch.einsum("ntke,ntkc,ntk->ntec", onehot, pos_oh, topv)

    dt = x.dtype
    xin = torch.einsum("ntec,ntd->necd", dispatch.to(dt), x)   # (N,E,cap,D)
    h = (F.silu(torch.einsum("necd,edf->necf", xin, p["wg"].to(dt)))
         * torch.einsum("necd,edf->necf", xin, p["wi"].to(dt)))
    xout = torch.einsum("necf,efd->necd", h, p["wo"].to(dt))
    y = torch.einsum("ntec,necd->ntd", combine.to(dt), xout)

    me = probs.mean(1)                                         # (N, E)
    ce = onehot.sum(2).mean(1)                                 # routed share
    aux = {"lb_loss": e * (me * ce).sum(-1),
           "z_loss": (torch.logsumexp(logits, dim=-1) ** 2).mean(-1),
           "dropped": 1.0 - in_cap.float().mean((1, 2))}
    return y, aux


def moe_apply(p, cfg: MoEConfig, x):
    """x: (B, S, D) -> (y, aux); aux holds 0-d f32 ``lb_loss``, ``z_loss``
    and ``dropped``."""
    b, s, d = x.shape
    tok = x.reshape(b * s, d)
    t = tok.shape[0]
    chunk = min(cfg.chunk, t)
    n_chunks = (t + chunk - 1) // chunk
    pad = n_chunks * chunk - t
    if pad:
        tok = F.pad(tok, (0, 0, 0, pad))
    ys, auxs = _dispatch(p, cfg, tok.reshape(n_chunks, chunk, d))
    y = ys.reshape(n_chunks * chunk, d)[:t].reshape(b, s, d)
    aux = {k: v.mean() for k, v in auxs.items()}
    if cfg.n_shared_experts:
        y = y + L.swiglu_apply(p["shared"], x)
    return y, aux
