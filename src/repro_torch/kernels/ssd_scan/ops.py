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
    nc, q, rep = l // chunk, chunk, h // g

    xbar = (x * dt[..., None]).reshape(b, nc, q, h, p)
    la = (-dt * A).float().reshape(b, nc, q, h)
    Bc = B.reshape(b, nc, q, g, n)
    Cc = C.reshape(b, nc, q, g, n)
    y_intra, states, dte, dfs = ssd_chunk(xbar, la, Bc, Cc)

    # the state before each chunk, stored (b, nc, g, n, rep, p) so that one
    # matrix product per (b, c, g) takes a group's rep heads side by side;
    # `before` views it (b, nc, g, rep, n, p), as the kernel's states
    a_last = torch.exp(la.sum(dim=2)).view(b, nc, g, rep, 1, 1)
    st = states.view(b, nc, g, rep, n, p)
    prev = torch.empty((b, nc, g, n, rep, p), dtype=torch.float32,
                       device=x.device)
    before = prev.permute(0, 1, 2, 4, 3, 5)
    before[:, 0].zero_()
    for c in range(1, nc):
        torch.addcmul(st[:, c - 1], before[:, c - 1], a_last[:, c - 1],
                      out=before[:, c])
    final = before[:, -1] * a_last[:, -1] + st[:, -1]       # (b,g,rep,n,p)

    # y_inter[q, (r, p)] = C[q, :] @ prev[:, (r, p)]: C in f32 once per
    # group, not per head; then y_intra += y_inter * dfs in place
    Cg = Cc.permute(0, 1, 3, 2, 4).float().reshape(b * nc * g, q, n)
    y_inter = torch.bmm(Cg, prev.view(b * nc * g, n, rep * p))
    y_intra.view(b, nc, q, g, rep, p).addcmul_(
        y_inter.view(b, nc, g, q, rep, p).transpose(2, 3),
        dfs.view(b, nc, q, g, rep, 1))
    y = y_intra.reshape(b, l, h, p).to(x.dtype)
    return y, final.reshape(b, h, n, p).transpose(-1, -2)   # (b,h,p,n)
