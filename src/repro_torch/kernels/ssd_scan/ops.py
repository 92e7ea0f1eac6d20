"""The whole chunked SSD over K8 (``repro/kernels/ssd_scan/ops.py``): the
kernel takes the chunk-local part; the inter-chunk recurrence (a loop over
the chunks with a small (b, h, n, p) carry) and the ``y_inter`` correction
stay in plain PyTorch, as the reference leaves them to XLA."""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ssd_scan import ssd_chunk


def ssd(x, dt, A, B, C, chunk):
    """x: (b,l,h,p)  dt: (b,l,h) (post-softplus)  A: (h,) positive
    B, C: (b,l,g,n).  Returns (y (b,l,h,p), final_state (b,h,p,n))."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"ssd: seq {l} not divisible by chunk {chunk}")
    nc, q = l // chunk, chunk

    xbar = (x * dt[..., None]).reshape(b, nc, q, h, p)
    la = (-dt * A).float().reshape(b, nc, q, h)
    Bc = B.reshape(b, nc, q, g, n)
    Cc = C.reshape(b, nc, q, g, n)
    y_intra, states, dte, dfs = ssd_chunk(xbar, la, Bc, Cc)

    a_last = torch.exp(la.sum(dim=2))                       # (b, nc, h)
    s = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):                 # state BEFORE each chunk
        prev.append(s)
        s = s * a_last[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                         # (b,nc,h,n,p)

    Crep = Cc.repeat_interleave(h // g, dim=3).float()      # (b,nc,q,h,n)
    y_inter = torch.einsum("bcqhn,bchnp,bcqh->bcqhp", Crep, prev, dfs)
    y = (y_intra + y_inter).reshape(b, l, h, p).to(x.dtype)
    return y, s.transpose(-1, -2)                           # (b,h,p,n)
