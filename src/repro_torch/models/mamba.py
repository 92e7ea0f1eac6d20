"""Mamba2 block via SSD (state-space duality, arXiv:2405.21060); the port of
``repro/models/mamba.py``.

Chunked algorithm: the sequence is split into chunks of Q tokens; the
quadratic intra-chunk term is batched matmuls and the inter-chunk state
recurrence is a loop over the chunks carrying (H, P, N) states.
``repro_torch.kernels.ssd_scan`` holds the hand kernel (K8) of the
intra-chunk compute; ``ssd_chunked`` here is the plain PyTorch version,
used as its oracle and whenever the kernel does not apply.

Decode path: O(1) per token — state update S <- dA * S + dt*x (x) B, output
y = C . S, the recurrent form of SSD.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 128          # N
    head_dim: int = 64          # P
    expand: int = 2
    n_groups: int = 1           # G
    d_conv: int = 4
    chunk: int = 128            # Q (SSD chunk length)
    conv_gather: bool = True    # window-gather conv (the reference default)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def mamba_init(gen, cfg: MambaConfig, device):
    d, di, h, g, n = (cfg.d_model, cfg.d_inner, cfg.n_heads,
                      cfg.n_groups, cfg.d_state)
    proj_out = 2 * di + 2 * g * n + h        # z, x, B, C, dt
    return {
        "in_proj": L._normal(gen, (d, proj_out), 1.0 / math.sqrt(d), device),
        "conv_w": L._normal(gen, (cfg.d_conv, cfg.conv_dim),
                            1.0 / math.sqrt(cfg.d_conv), device),
        "conv_b": torch.zeros((cfg.conv_dim,), device=device),
        "dt_bias": torch.zeros((h,), device=device),
        # A in (-exp range); stored as log for positivity
        "A_log": torch.log(torch.linspace(1.0, 16.0, h)).to(device),
        "D": torch.ones((h,), device=device),
        "norm_scale": torch.ones((di,), device=device),
        "out_proj": L._normal(gen, (di, d), 1.0 / math.sqrt(di), device),
    }


def mamba_axes(cfg: MambaConfig):
    """``mamba_init``'s logical axes."""
    return {"in_proj": ("embed", "inner_proj"),
            "conv_w": (None, "inner_proj"),
            "conv_b": ("inner_proj",),
            "dt_bias": ("heads",),
            "A_log": ("heads",),
            "D": ("heads",),
            "norm_scale": ("inner",),
            "out_proj": ("inner", "embed")}


def _segsum(log_a):
    """log_a: (..., Q).  Returns (..., Q, Q) with S[i,j] = sum_{j<m<=i}
    log_a[m] for j<=i, -inf above the diagonal."""
    q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=log_a.device).tril()
    return torch.where(mask, seg, -math.inf)


def ssd_chunked(x, dt, A, B, C, chunk, init_state=None):
    """SSD forward.
    x: (b, l, h, p)   dt: (b, l, h) (post-softplus, >0)
    A: (h,) (positive; decay = exp(-dt*A))   B, C: (b, l, g, n)
    Returns y: (b, l, h, p), final_state: (b, h, p, n).
    """
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = chunk
    if l % q:
        raise ValueError(f"seq {l} not divisible by chunk {q}")
    nc = l // q
    rep = h // g

    xb = x * dt[..., None]                            # discretized input
    log_a = (-dt * A).float()                         # (b, l, h) log decay
    xc = xb.reshape(b, nc, q, h, p).float()
    lac = log_a.reshape(b, nc, q, h)
    Brep = B.reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3).float()
    Crep = C.reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3).float()

    # --- intra-chunk (quadratic within chunk; K8 computes the same) ---
    Lmat = torch.exp(_segsum(lac.transpose(2, 3)))    # (b, nc, h, q, q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Crep, Brep)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores * Lmat, xc)

    # --- chunk summary states ---
    a_last = torch.exp(lac.sum(dim=2))                # (b, nc, h) total decay
    decay_to_end = torch.exp(lac.sum(dim=2)[:, :, None, :]
                             - torch.cumsum(lac, dim=2))   # (b, nc, q, h)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          decay_to_end[..., None] * Brep, xc)

    # --- inter-chunk recurrence (state BEFORE each chunk) ---
    s = (torch.zeros((b, h, p, n), device=x.device) if init_state is None
         else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * a_last[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)            # (b, nc, h, p, n)

    # --- inter-chunk output ---
    decay_from_start = torch.exp(torch.cumsum(lac, dim=2))   # (b, nc, q, h)
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp",
                           Crep, prev_states, decay_from_start)
    y = (y_intra + y_inter).reshape(b, l, h, p)
    return y.to(x.dtype), s


def mamba_apply(p, cfg: MambaConfig, x, cache=None, use_pallas=False):
    """x: (B, S, D).  cache: None or one layer's {"conv": (B, d_conv-1,
    conv_dim), "ssm": (B, H, P, N) f32}.  Returns (y, new_cache).

    Unlike the reference, the cache's tensors are updated in place and
    returned.  ``use_pallas`` sends a cacheless forward whose length is a
    multiple of the chunk to K8."""
    b, s, d = x.shape
    di, h, g, n, pd = (cfg.d_inner, cfg.n_heads, cfg.n_groups,
                       cfg.d_state, cfg.head_dim)
    proj = x @ p["in_proj"].to(x.dtype)              # (B,S,2di+2gn+h)
    z, xbc, dt_raw = torch.split(proj, [di, cfg.conv_dim, h], dim=-1)

    if cache is None:
        # causal depthwise conv via padding
        pad = torch.zeros((b, cfg.d_conv - 1, cfg.conv_dim), dtype=xbc.dtype,
                          device=x.device)
        xpad = torch.cat([pad, xbc], dim=1)
    else:
        xpad = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)
    new_conv_state = xpad[:, xpad.shape[1] - (cfg.d_conv - 1):, :]

    cw = p["conv_w"].to(xbc.dtype)
    if cfg.conv_gather:
        # the reference's (B, S, d_conv, C) window gather
        idx = (torch.arange(s, device=x.device)[:, None]
               + torch.arange(cfg.d_conv, device=x.device)[None, :])
        acc = torch.einsum("bskc,kc->bsc", xpad[:, idx, :], cw)
    else:
        # d_conv shifted scaled slices
        acc = xpad[:, :s, :] * cw[0]
        for k in range(1, cfg.d_conv):
            acc = acc + xpad[:, k:k + s, :] * cw[k]
    xbc = F.silu(acc + p["conv_b"].to(xbc.dtype))

    xin, B_, C_ = torch.split(xbc, [di, g * n, g * n], dim=-1)
    xin = xin.reshape(b, s, h, pd)
    B_ = B_.reshape(b, s, g, n)
    C_ = C_.reshape(b, s, g, n)
    # JAX's softplus is logaddexp(x, 0); F.softplus returns x above 20
    dt_in = dt_raw.float() + p["dt_bias"]
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))   # (B,S,H)
    A = torch.exp(p["A_log"])                         # (H,) positive

    if cache is None or s > 1:
        # a cacheless forward, or (chained) prefill with an incoming state
        s0 = cache["ssm"] if cache is not None else None
        if use_pallas and s % cfg.chunk == 0 and s0 is None:
            from repro_torch.kernels.ssd_scan import ops as ssd_ops
            y, final = ssd_ops.ssd(xin, dt, A, B_, C_, cfg.chunk)
        else:
            ch = cfg.chunk if s % cfg.chunk == 0 else _best_chunk(s)
            y, final = ssd_chunked(xin, dt, A, B_, C_, ch, init_state=s0)
        new_ssm = final
    else:
        # recurrent decode: S <- exp(-dt A) S + dt x B^T ; y = C . S
        S = cache["ssm"]                              # (B,H,P,N)
        da = torch.exp(-dt[:, 0, :] * A)              # (B,H)
        Brep = B_.repeat_interleave(h // g, dim=2)[:, 0]   # (B,H,N)
        Crep = C_.repeat_interleave(h // g, dim=2)[:, 0]   # (B,H,N)
        xd = (xin[:, 0] * dt[:, 0, :, None]).float()  # (B,H,P)
        S = S * da[:, :, None, None] + torch.einsum("bhp,bhn->bhpn", xd,
                                                    Brep.float())
        y = torch.einsum("bhn,bhpn->bhp", Crep.float(), S)[:, None]
        new_ssm = S

    y = y + xin.to(y.dtype) * p["D"][:, None]
    y = y.reshape(b, s, di).to(x.dtype)
    # gated RMSNorm (mamba2's norm-before-out-proj)
    y = L.rmsnorm_apply({"scale": p["norm_scale"]}, y * F.silu(z))
    out = y @ p["out_proj"].to(x.dtype)
    if cache is None:
        return out, {"conv": new_conv_state, "ssm": new_ssm}
    cache["conv"].copy_(new_conv_state)
    cache["ssm"].copy_(new_ssm)
    return out, cache


def _best_chunk(s: int) -> int:
    for c in (128, 64, 32, 16, 8, 4, 2, 1):
        if s % c == 0:
            return c
    return 1


def mamba_cache_init(cfg: MambaConfig, batch: int, dtype=torch.bfloat16,
                     device=None):
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                           dtype=torch.float32, device=device),
    }
