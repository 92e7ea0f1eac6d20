"""How far the order of K8's cumsum moves its outputs, on the CPU.

K8 takes cs = cumsum(la) over each chunk and then exp(cs_i - cs_j).  Its
plain version (``kernels/ssd_scan/ref.py``) sums la in order, in f32.  This
script computes the chunk function twice from the same inputs, phase 3's
draw at a quarter of the scoring shape (b 1, 4 chunks of 128, 24 heads,
p 64, state 128; dt = softplus(randn), A from 1 to 16): once with the
plain version's cumsum and once with the order of a warp-shuffle scan (a
Hillis-Steele scan within each warp of 32, then the warps' totals added
in order), and prints each output's largest error against the plain
version and its largest ratio to the 3e-4 bar (atol = rtol = 3e-4).  A
ratio above 1 fails phase 3.  Everything else is the plain version's
arithmetic, so only the order of the cumsum differs.

    PYTHONPATH=src python3 tools/k8_scan_order.py
"""

import torch

from repro_torch.kernels.ssd_scan import ref as SR


def warp_scan(la):
    """Inclusive cumsum over the last axis (<= 128) in a warp-shuffle
    scan's order."""
    q = la.shape[-1]
    v = torch.zeros(la.shape[:-1] + (128,))
    v[..., :q] = la
    v = v.unflatten(-1, (4, 32))
    for o in (1, 2, 4, 8, 16):
        v = v + torch.nn.functional.pad(v[..., :-o], (o, 0))
    out = v.clone()
    for w in range(1, 4):
        for w2 in range(w):
            out[..., w, :] = out[..., w, :] + v[..., w2, 31:]
    return out.flatten(-2)[..., :q]


def chunk(xbar, la, B, C, scan):
    """The plain version's chunk function with the cumsum ``scan``."""
    q, h = xbar.shape[2], xbar.shape[3]
    rep = h // B.shape[3]
    x = xbar.permute(0, 1, 3, 2, 4)
    Bh = B.float().repeat_interleave(rep, dim=3).permute(0, 1, 3, 2, 4)
    Ch = C.float().repeat_interleave(rep, dim=3).permute(0, 1, 3, 2, 4)
    cs = scan(la.permute(0, 1, 3, 2).contiguous())              # (b,nc,h,q)
    tril = torch.ones((q, q), dtype=torch.bool).tril()
    lmat = torch.where(tril, torch.exp(cs[..., :, None] - cs[..., None, :]),
                       0.0)
    y = ((Ch @ Bh.transpose(-1, -2)) * lmat) @ x
    dte = torch.exp(cs[..., -1:] - cs)
    states = (Bh * dte[..., None]).transpose(-1, -2) @ x
    return (y.permute(0, 1, 3, 2, 4), states, dte.permute(0, 1, 3, 2),
            torch.exp(cs).permute(0, 1, 3, 2))


def main():
    gen = torch.Generator().manual_seed(1)
    b, nc, q, h, p, g, n = 1, 4, 128, 24, 64, 1, 128
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((b, nc, q, h, p), generator=gen)
        dtv = torch.nn.functional.softplus(
            torch.randn((b, nc, q, h), generator=gen))
        conv = torch.randn((b, nc, q, 2 * g * n + h), generator=gen).to(dt)
        args = (x * dtv[..., None], -dtv * torch.linspace(1.0, 16.0, h),
                conv[..., :g * n].unflatten(-1, (g, n)),
                conv[..., g * n:2 * g * n].unflatten(-1, (g, n)))
        want = SR.ssd_chunk_ref(*args)
        for name, scan in (("in order", lambda t: torch.cumsum(t, -1)),
                           ("warp-shuffle", warp_scan)):
            got = chunk(*args, scan)
            cells = []
            for label, a, w in zip(("y_intra", "states", "dte", "dfs"), got,
                                   want):
                e = (a - w).abs()
                cells.append(f"{label} {float(e.max()):.3g} "
                             f"(x{float((e / (3e-4 + 3e-4 * w.abs())).max()):.3g})")
            print(f"B/C {str(dt)[6:]}, cumsum {name}: largest error (ratio "
                  f"to the 3e-4 bar): {', '.join(cells)}")


if __name__ == "__main__":
    main()
