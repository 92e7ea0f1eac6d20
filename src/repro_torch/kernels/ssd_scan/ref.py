"""Plain PyTorch version of the SSD kernel (K8): the chunk function the
kernel computes (the reference's Pallas ``_kernel``), batched over
(b, c, h).  The whole chunked SSD's plain version is the model layer's
``models.mamba.ssd_chunked``."""

from __future__ import annotations

import torch


def ssd_chunk_ref(xbar, la, B, C):
    """xbar: (b, nc, q, h, p) f32, la: (b, nc, q, h) f32, B, C: (b, nc, q,
    g, n).  Returns y_intra (b, nc, q, h, p), states (b, nc, h, n, p), dte
    and dfs (b, nc, q, h), all f32."""
    q, h = xbar.shape[2], xbar.shape[3]
    rep = h // B.shape[3]
    x = xbar.float().permute(0, 1, 3, 2, 4)                   # (b,nc,h,q,p)
    Bh = B.float().repeat_interleave(rep, dim=3).permute(0, 1, 3, 2, 4)
    Ch = C.float().repeat_interleave(rep, dim=3).permute(0, 1, 3, 2, 4)
    cs = torch.cumsum(la.float(), dim=2).permute(0, 1, 3, 2)  # (b,nc,h,q)
    tril = torch.ones((q, q), dtype=torch.bool, device=xbar.device).tril()
    lmat = torch.where(tril, torch.exp(cs[..., :, None] - cs[..., None, :]),
                       0.0)
    y = ((Ch @ Bh.transpose(-1, -2)) * lmat) @ x              # (b,nc,h,q,p)
    dte = torch.exp(cs[..., -1:] - cs)                        # (b,nc,h,q)
    dfs = torch.exp(cs)
    states = (Bh * dte[..., None]).transpose(-1, -2) @ x      # (b,nc,h,n,p)
    return (y.permute(0, 1, 3, 2, 4).contiguous(), states,
            dte.permute(0, 1, 3, 2).contiguous(),
            dfs.permute(0, 1, 3, 2).contiguous())

