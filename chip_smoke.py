"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--steps N] [--profile]

Phases, in order; any failure exits nonzero before the last line:
  1. print the card's name and power limit (``nvidia-smi``);
  2. build the kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
     per source, all started together);
  3. hold K1 (quantize), K2 (dequantize), K3 (fused roundtrip) and K4
     (fused roundtrip + cut noise, masked and unmasked) bit for bit against
     their plain PyTorch versions on the card, in f32 and bf16, at the main
     path's shape (250,880 x 160) and a ragged one (7 x 96), check K3 ==
     K2(K1(x)) and K4 == K3 + the masked add; hold K5 (per-example squared
     norms) and K6 (scaled batch sum) within 1e-6 relative of theirs over
     one hospital's real 364-leaf per-example gradient table (16 x
     6,948,609 f32) and a ragged small one; hold K7 (flash attention: f32
     on CUDA cores, bf16 on tensor cores) within the reference's bars (2e-6
     f32, 2e-2 bf16) at its test shapes, a ragged GQA case in both types
     and head_dim-128 cases in bf16, and at the scoring shape (4 x 9/3
     heads x 2048 x 64, causal: 1e-5 f32, 2e-2 bf16), and K8 (SSD
     chunk) within 3e-4 at small shapes and at the scoring shape (4 x 16
     chunks x 128 x 24 heads x 64, state 128); time each with CUDA events
     beside its bound and, for K5-K7, one PyTorch call (K7: SDPA);
  4. train SplitFedv3 (``sflv3_ac``) on DenseNet-121-mini at 32^2 on the
     card and on the CPU from the same start, and hold the card's losses
     and scores against the CPU's plain path over an identity link (the
     int8 link's difference is printed); then the same privately (DP-SGD
     with noise 0 and C = 1: deterministic), losses within 1e-4; and run
     SmolLM's and Mamba2's SMOKE configs in f32 on the card and the CPU
     (scoring logits, loss, greedy tokens);
  5. the main path: SplitFedv3 on DenseNet-121 at 224^2, 5 synthetic
     hospitals, batch 16 per hospital, over ``Transport("int8")`` fused
     (K3) and unfused (K1, K2), then ``val_loss`` and
     ``evaluate``; the first step's losses of the two runs must be
     bit-identical and every launch count of the path nonzero;
  6. the private main path: the same with ``PrivacyConfig(noise_multiplier
     =1.0, clip_norm=1.0, cut_noise_std=0.5)`` over the int8 link fused
     (K4, K5, K6) and unfused (K1, K2 + the masked add, K5, K6), first-step
     losses bit-identical, every launch count nonzero, then
     ``privacy_report``, ``val_loss`` and ``evaluate``; and a cut-noise-only
     run (DP off) with one K4 launch per step over all hospitals' rows;
  7. LM serving at published width, random weights, bf16: SmolLM-135M and
     Mamba2-130M score 4 prompts of 2048 tokens with ``apply`` and
     ``loss`` (use_pallas: K7 30 or K8 24 launches per forward), then over
     the int8 cut link at layer 4 (K3 once more), each against the same
     call with use_pallas=False; then ``greedy_generate`` 32 tokens after
     4 prompts of 256 over the caches (no kernel), tokens per second;
  8. print one JSON line ``{"kernels": [...]}`` (K1-K8), then the last
     line ``{"ok": true, "device": {...}}``.

``--profile`` adds one profiled fused step of each main path and one
profiled scoring forward of each LM (``torch.profiler``) and prints the
device time by kernel.  The script imports nothing of JAX or of the
JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12              # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12            # bf16 tensor cores, dense
MAIN_ROWS, MAIN_D = 80 * 56 * 56, 160   # the cut tensor of 5 x 16 images
# operations per element of each kernel: K1 abs, max, divide, round, clamp;
# K2 convert, multiply; K3 both; K4 K3's and the noise multiply and add;
# K5 multiply, add; K6 multiply, add
OPS_PER_ELEM = {"K1": 5, "K2": 2, "K3": 7, "K4": 9, "K5": 2, "K6": 2}
BATCH = 16                       # images per hospital and step at 224^2
PRIVACY = dict(noise_multiplier=1.0, clip_norm=1.0, cut_noise_std=0.5,
               seed=0)           # examples/private_splitfed.py's defaults
CUDA_SRC = "src/repro_torch/kernels/csrc/"
# the LM scoring path (phase 7): 4 prompts of 2048 tokens
LM_BATCH, LM_SEQ = 4, 2048
LM_ATTN = (LM_BATCH, 9, 3, LM_SEQ, 64)      # SmolLM-135M: B, H, KV, S, D
LM_SSD = (LM_BATCH, LM_SEQ // 128, 128, 24, 64, 1, 128)  # Mamba2-130M:
                                            # b, nc, q, h, p, g, n
GEN_PROMPT, GEN_NEW = 256, 32               # greedy_generate, 4 prompts
# K7 in bf16 at LM_ATTN: the largest ||out - ref|| / ||ref|| over rows
K7_ROW_REL = 2e-2


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def roof(nbytes: int, ops):
    """(bound_ms, bound_by): the larger of the bytes the function must
    move over HBM bandwidth and its operations, ``[(count, peak per s),
    ...]``, each over the card's peak rate for its operands' type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / peak for n, peak in ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(name: str, rows: int, d: int, in_bytes: int, out_bytes: int):
    """The row kernels K1-K6: a few f32 operations per element."""
    return roof(in_bytes + out_bytes,
                [(OPS_PER_ELEM[name] * rows * d, F32_OPS_PER_S)])


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev):
    import torch
    from repro_torch.kernels.act_compress import act_compress as AC
    from repro_torch.kernels.act_compress import ref as R
    from repro_torch.kernels.cut_fuse import cut_fuse as CF
    from repro_torch.kernels.cut_fuse import ref as RF

    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    for shape in [(MAIN_ROWS, MAIN_D), (7, 96)]:
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, device=dev, generator=gen) * 3).to(dt)
            z = torch.randn(shape, device=dev, generator=gen) * 0.5
            q, s = AC.quantize_rows(x)
            q_r, s_r = R.quantize_ref(x)
            out = AC.dequantize_rows(q_r, s_r, dt)
            out_r = R.dequantize_ref(q_r, s_r, dt)
            rt = CF.roundtrip_rows(x)
            rt_r = R.roundtrip_ref(x)
            torch.cuda.synchronize()
            k1 = torch.equal(q, q_r) and torch.equal(s, s_r)
            k2 = torch.equal(out, out_r)
            k3 = torch.equal(rt, rt_r)
            composed = torch.equal(rt, AC.dequantize_rows(q, s, dt))
            err["K1"] = max(err["K1"], max_err(q, q_r), max_err(s, s_r))
            err["K2"] = max(err["K2"], max_err(out, out_r))
            err["K3"] = max(err["K3"], max_err(rt, rt_r))
            k4 = []
            for masked in (False, True):
                w = torch.ones((shape[0], 1), device=dev)
                if masked:
                    w = (torch.rand((shape[0], 1), device=dev, generator=gen)
                         < 0.6).float()
                nz = CF.noise_roundtrip_rows(x, z, w)
                nz_r = RF.noise_roundtrip_ref(x, z, w)
                torch.cuda.synchronize()
                err["K4"] = max(err["K4"], max_err(nz, nz_r))
                k4.append(torch.equal(nz, nz_r)
                          and torch.equal(nz, rt + (z * w).to(dt)))
            log(f"  {tuple(shape)} {str(dt)[6:]}: K1 {k1}  K2 {k2}  K3 {k3}"
                f"  K3==K2(K1) {composed}  K4==plain==K3+add unmasked "
                f"{k4[0]} masked {k4[1]}")
            if not (k1 and k2 and k3 and composed and all(k4)):
                fail(f"kernel disagrees with its plain version at {shape} "
                     f"{dt}")

    # time at the main path's shape and dtype (f32): 160 MB in, so every
    # launch finds its input outside the 50 MB L2
    x = torch.randn((MAIN_ROWS, MAIN_D), device=dev, generator=gen) * 3
    z = torch.randn((MAIN_ROWS, MAIN_D), device=dev, generator=gen) * 0.5
    w = torch.ones((MAIN_ROWS, 1), device=dev)
    q, s = AC.quantize_rows(x)
    n, t = x.numel(), MAIN_ROWS
    rows = [
        ("K1", "cut_quantize", "src/repro/kernels/act_compress/"
         "act_compress.py:37", lambda: AC.quantize_rows(x),
         lambda: R.quantize_ref(x), 4 * n, n + 4 * t),
        ("K2", "cut_dequantize", "src/repro/kernels/act_compress/"
         "act_compress.py:57", lambda: AC.dequantize_rows(q, s, x.dtype),
         lambda: R.dequantize_ref(q, s, x.dtype), n + 4 * t, 4 * n),
        ("K3", "cut_roundtrip", "src/repro/kernels/cut_fuse/cut_fuse.py:80",
         lambda: CF.roundtrip_rows(x), lambda: R.roundtrip_ref(x),
         4 * n, 4 * n),
        ("K4", "cut_noise_roundtrip",
         "src/repro/kernels/cut_fuse/cut_fuse.py:98",
         lambda: CF.noise_roundtrip_rows(x, z, w),
         lambda: RF.noise_roundtrip_ref(x, z, w), 8 * n + 4 * t, 4 * n),
    ]
    table = {}
    for key, name, replaces, kern, plain, nin, nout in rows:
        # no single PyTorch call computes per-row absmax int8 (K1-K4)
        table[key] = timed_row(key, name, "cut_layer.cu", replaces, kern,
                               plain, None, f"{t} x {MAIN_D} f32",
                               bound(key, t, MAIN_D, nin, nout), err[key])
    del x, z, w, q, s
    table.update(check_dp_clip(dev, gen))
    return table


def timed_row(key, name, source, replaces, kern, plain, library, shape,
              roofline, err):
    """Time a kernel, its plain version and (if any) one library call in
    the order plain, kernel, library, library, kernel, plain; each the
    mean of its pair, both of which are printed.  ``roofline``: (bound_ms,
    bound_by); ``shape``: the label of the timed shape."""
    p0, k0 = cuda_ms(plain), cuda_ms(kern)
    l0 = cuda_ms(library) if library else None
    l1 = cuda_ms(library) if library else None
    k1, p1 = cuda_ms(kern), cuda_ms(plain)
    b_ms, b_by = roofline
    row = {"name": name, "route": "cuda", "source": CUDA_SRC + source,
           "replaces": replaces, "launches": 0, "max_abs_err": err,
           "ms": (k0 + k1) / 2, "plain_ms": (p0 + p1) / 2, "bound_ms": b_ms,
           "bound_by": b_by,
           "library_ms": None if library is None else (l0 + l1) / 2}
    lib = ("" if library is None else f", one library call "
           f"{row['library_ms']:.4f} ms ({l0:.4f}, {l1:.4f})")
    log(f"  {key} {name}: {row['ms']:.4f} ms ({k0:.4f}, {k1:.4f}; plain "
        f"{row['plain_ms']:.4f} ms ({p0:.4f}, {p1:.4f}){lib}, bound "
        f"{b_ms:.4f} ms by {b_by}) at {shape}")
    return row


def rel_err(a, b) -> float:
    """max |a - b| over max |b| (the clip's sums cancel, so an elementwise
    relative error says nothing where b is near 0)."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


def check_dp_clip(dev, gen):
    """K5 and K6 over one hospital's per-example gradient table of
    DenseNet-121 (364 leaves, 16 x 6,948,609 f32) and a ragged small table:
    within 1e-6 relative of their plain versions (the kernels sum in
    double, the plain versions in f32 in another order)."""
    import torch
    from repro_torch.configs.paper_models import DENSENET121_PAPER
    from repro_torch.core.partition import META, cnn_adapter
    from repro_torch.kernels.dp_clip import dp_clip as DC
    from repro_torch.kernels.dp_clip import ref as RD
    from repro_torch.models.cnn import build_densenet
    from repro_torch.tree import tree_leaves

    shapes = [tuple(l.shape) for l in tree_leaves(cnn_adapter(
        build_densenet(DENSENET121_PAPER)).init(None, META))]
    err = {"K5": 0.0, "K6": 0.0}
    for label, b, sizes in [
            ("real", BATCH, [math.prod(sh) for sh in shapes]),
            ("ragged", 3, [130, 7, 1, 5000, 4097, 33])]:
        leaves = [torch.randn((b, n), device=dev, generator=gen) * 0.01
                  for n in sizes]
        lt = DC.leaf_table(leaves)
        sq = DC.sqnorms_leaves(lt)
        sq_r = sum(RD.sqnorms_ref(l) for l in leaves).reshape(-1)
        scales = RD.clip_scales(sq_r.reshape(b, 1), 1.0)
        sums = DC.scale_accum_leaves(lt, scales)
        sums_r = [RD.scale_accum_ref(l, scales).reshape(-1) for l in leaves]
        torch.cuda.synchronize()
        r5 = rel_err(sq, sq_r)
        r6 = max(rel_err(a, b_) for a, b_ in zip(sums, sums_r))
        err["K5"] = max(err["K5"], max_err(sq, sq_r))
        err["K6"] = max(err["K6"], max(max_err(a, b_)
                                       for a, b_ in zip(sums, sums_r)))
        log(f"  {label} table: {len(leaves)} leaves, {b} x {sum(sizes)} f32;"
            f" K5 relative error {r5:.3g}, K6 {r6:.3g} (limit 1e-6)")
        if not (r5 <= 1e-6 and r6 <= 1e-6):
            fail(f"K5/K6 disagree with their plain versions ({label})")
    # time over the real table; the library calls take the leaves
    # concatenated into one (16, 6,948,609) matrix.  The table is checked
    # and uploaded once per clip for both kernels (host work, timed apart)
    leaves_real = [torch.randn((BATCH, math.prod(sh)), device=dev,
                               generator=gen) for sh in shapes]
    big = torch.cat(leaves_real, dim=1)
    s = torch.rand((BATCH, 1), device=dev, generator=gen)
    n, d = big.numel(), big.shape[1]
    t0 = time.perf_counter()
    for _ in range(20):
        lt = DC.leaf_table(leaves_real)
    log(f"  leaf_table (check + upload of 364 leaves, host clock): "
        f"{(time.perf_counter() - t0) / 20 * 1e3:.4f} ms per clip")
    # K6 is timed as scale_accum_flat (the launch into one flat output);
    # scale_accum_leaves also cuts that output into 364 views, host work
    # that can outlast the kernel (CUDA events then time the host)
    log(f"  scale_accum_leaves (K6 + the 364 views): "
        f"{cuda_ms(lambda: DC.scale_accum_leaves(lt, s)):.4f} ms per call")
    table = {
        "K5": timed_row(
            "K5", "dp_sqnorms", "dp_clip.cu",
            "src/repro/kernels/dp_clip/dp_clip.py:44",
            lambda: DC.sqnorms_leaves(lt),
            lambda: sum(RD.sqnorms_ref(l) for l in leaves_real),
            lambda: torch.linalg.vecdot(big, big), f"{BATCH} x {d} f32",
            bound("K5", BATCH, d, 4 * n, 4 * BATCH), err["K5"]),
        "K6": timed_row(
            "K6", "dp_scale_accum", "dp_clip.cu",
            "src/repro/kernels/dp_clip/dp_clip.py:62",
            lambda: DC.scale_accum_flat(lt, s),
            lambda: [RD.scale_accum_ref(l, s) for l in leaves_real],
            lambda: s.reshape(1, BATCH) @ big, f"{BATCH} x {d} f32",
            bound("K6", BATCH, d, 4 * n + 4 * BATCH, 4 * d), err["K6"]),
    }
    return table


def check_lm_kernels(dev, gen):
    """K7 and K8 against their plain versions (f32 on the card: no TF32),
    at the reference's kernel-test shapes with its bars (K7 2e-6 in f32,
    2e-2 in bf16; K8 3e-4), at small ragged shapes, and at the scoring
    shape of phase 7 in model layout; then timed at the scoring shape."""
    import torch
    from repro_torch.device import use_full_fp32
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.ssd_scan import ref as SR
    from repro_torch.kernels.ssd_scan import ssd_scan as SS

    use_full_fp32(dev)
    err = {"K7": 0.0, "K8": 0.0}

    def attn_inputs(b, h, kv, s, d, dt):
        # model layout (B, S, H, D) in memory, as the path hands them over
        return [torch.randn((b, s, n, d), device=dev, generator=gen).to(
            dt).transpose(1, 2) for n in (h, kv, kv)]

    # (shape, causal, dtype, bar): at the scoring shape the f32 sums run
    # over up to 2048 keys in another order than the plain version's:
    # 1e-5 in f32; bf16 keeps the reference's 2e-2 (the tensor-core kernel
    # rounds P to bf16 before P V, then the output once).  The bf16 cases
    # hold the tensor-core kernel at head_dim 32, 64 and 128 and at ragged
    # last tiles (S 80 and 96 are not multiples of its 64-row tiles)
    cases = [((1, 2, 1, 128, 64), c, dt, 2e-6 if dt == torch.float32
              else 2e-2) for c in (True, False)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [((2, 4, 2, 256, 64), True, torch.float32, 2e-6),
              ((2, 4, 2, 256, 64), False, torch.bfloat16, 2e-2),
              ((1, 6, 2, 80, 32), True, torch.float32, 2e-6),    # ragged GQA
              ((1, 6, 2, 80, 32), True, torch.bfloat16, 2e-2),
              ((1, 4, 1, 96, 128), False, torch.bfloat16, 2e-2),
              ((1, 4, 1, 96, 128), True, torch.bfloat16, 2e-2),
              (LM_ATTN, True, torch.float32, 1e-5),
              (LM_ATTN, True, torch.bfloat16, 2e-2)]
    # At the scoring shape a causal row averages v over up to 2048 keys,
    # so late rows are of order 0.03 and the absolute bf16 bar alone would
    # miss a 64-key tile dropped from them: there each row's error is also
    # held relative to the row, ||out - ref|| / ||ref|| (bar K7_ROW_REL)
    for shape, causal, dt, bar in cases:
        q, k, v = attn_inputs(*shape, dt)
        out = FA.flash_attention_bhsd(q, k, v, causal)
        ref = FR.flash_attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        e = max_err(out, ref)
        err["K7"] = max(err["K7"], e)
        rbar = K7_ROW_REL if shape == LM_ATTN and dt == torch.bfloat16 \
            else None
        r = float(((out.float() - ref.float()).norm(dim=-1)
                   / ref.float().norm(dim=-1).clamp_min(1e-30)).max())
        log(f"  K7 {shape} {'causal' if causal else 'full'} "
            f"{str(dt)[6:]}: max |kernel - plain| {e:.3g} (bar {bar:g}); "
            f"largest row-relative error {r:.3g}"
            + ("" if rbar is None else f" (bar {rbar:g})"))
        if not (out.dtype == dt and e <= bar
                and (rbar is None or r <= rbar)):
            fail(f"K7 disagrees with its plain version at {shape}")

    def ssd_inputs(b, nc, q, h, p, g, n, dt):
        """As mamba_apply makes them: xbar = x * dt, la = -dt * A (A from 1
        to 16), B and C column slices of one (.., 2 g n + h) tensor."""
        x = torch.randn((b, nc, q, h, p), device=dev, generator=gen)
        dtv = torch.nn.functional.softplus(
            torch.randn((b, nc, q, h), device=dev, generator=gen))
        A = torch.linspace(1.0, 16.0, h, device=dev)
        conv = torch.randn((b, nc, q, 2 * g * n + h), device=dev,
                           generator=gen).to(dt)
        return (x * dtv[..., None], -dtv * A,
                conv[..., :g * n].unflatten(-1, (g, n)),
                conv[..., g * n:2 * g * n].unflatten(-1, (g, n)))

    for dims, dt in [((1, 4, 16, 2, 16, 1, 16), torch.float32),
                     ((1, 3, 32, 3, 16, 1, 64), torch.float32),
                     ((2, 3, 8, 8, 32, 2, 16), torch.bfloat16),
                     (LM_SSD, torch.float32), (LM_SSD, torch.bfloat16)]:
        args = ssd_inputs(*dims, dt)
        got, want = SS.ssd_chunk(*args), SR.ssd_chunk_ref(*args)
        torch.cuda.synchronize()
        ok = all(torch.allclose(a, b, atol=3e-4, rtol=3e-4)
                 for a, b in zip(got, want))
        e = max(max_err(a, b) for a, b in zip(got, want))
        err["K8"] = max(err["K8"], e)
        log(f"  K8 {dims} B/C {str(dt)[6:]}: max |kernel - plain| {e:.3g}, "
            f"within atol = rtol = 3e-4: {ok}")
        if not ok:
            fail(f"K8 disagrees with its plain version at {dims}")

    # timed at the scoring shape, bf16 as the path runs them
    q, k, v = attn_inputs(*LM_ATTN, torch.bfloat16)
    b, h, kv, s, d = LM_ATTN
    o = torch.empty_like(q)
    pairs = b * h * s * (s + 1) // 2             # causal: keys j <= i
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, o))
    table = {"K7": timed_row(
        "K7", "flash_attention_fwd", "flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:86",
        lambda: FA.flash_attention_bhsd(q, k, v, True),
        lambda: FR.flash_attention_ref(q, k, v, True),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
        f"{LM_ATTN} bf16 causal",
        roof(nbytes, [(4 * d * pairs, BF16_OPS_PER_S)]), err["K7"])}
    del q, k, v, o
    args = ssd_inputs(*LM_SSD, torch.bfloat16)
    b, nc, qq, h, p, g, n = LM_SSD
    outs = SS.ssd_chunk(*args)
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs))
    tri = b * nc * h * qq * (qq + 1) // 2        # (i, j) with j <= i
    table["K8"] = timed_row(
        "K8", "ssd_chunk_fwd", "ssd_scan.cu",
        "src/repro/kernels/ssd_scan/ssd_scan.py:61",
        lambda: SS.ssd_chunk(*args), lambda: SR.ssd_chunk_ref(*args), None,
        f"{LM_SSD} B/C bf16",
        roof(nbytes, [(2 * tri * n, BF16_OPS_PER_S),
                      (2 * tri * p + 2 * b * nc * h * qq * n * p,
                       F32_OPS_PER_S)]), err["K8"])
    return table


# ---------------------------------------------------------------------------
# phases 4 and 5: the SplitFedv3 slice
# ---------------------------------------------------------------------------

def sflv3(cfg, clients, batch, device, fuse, seed=0, step_seconds=None,
          codec="int8", privacy=None, n_train=None):
    """Build the slice as a user would and train one epoch (on the first
    ``n_train`` train images of each hospital, all by default); with a
    list ``step_seconds`` each step is timed on the host clock between two
    device synchronisations.  ``privacy``: PrivacyConfig keywords."""
    import numpy as np
    import torch

    from repro_torch import optim as O
    from repro_torch.core.partition import cnn_adapter
    from repro_torch.core.strategies import make_strategy
    from repro_torch.models.cnn import build_densenet
    from repro_torch.privacy import PrivacyConfig
    from repro_torch.wire import Transport

    adapter = cnn_adapter(build_densenet(cfg))
    transport = Transport(codec, fuse=fuse, device=device)
    strat = make_strategy(
        "sflv3_ac", adapter, lambda: O.adam(1e-4), len(clients),
        transport=transport, device=device,
        privacy=None if privacy is None else PrivacyConfig(**privacy))
    if step_seconds is not None:
        step = strat._step3

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            step_seconds.append(time.perf_counter() - t0)
            return out
        strat._step3 = timed
    state = strat.setup(seed)
    train = [{k: v[:n_train] for k, v in c.train.items()} for c in clients]
    state, epoch = strat.run_epoch(state, train, np.random.default_rng(1),
                                   batch)
    return strat, state, epoch, transport


def small_against_cpu(dev):
    """DenseNet-mini at 32^2 on the card and on the CPU (plain path) from
    the same seed, over an identity link: losses and scores within 1e-4
    (float32 round-off of cuDNN's and ATen's convolutions, as the CPU
    tests allow against the JAX package).  Over the int8 link only the
    first step's losses are held to 1e-4 and the rest is printed: a
    cut-tensor element within round-off of a half level lands on the
    neighbouring level on one side, and Adam turns that into another
    update, so later steps measure the link's sensitivity, not the port's
    arithmetic (phase 3 holds the kernels bit for bit)."""
    import numpy as np

    from repro_torch.configs.paper_models import DENSENET_MINI
    from repro_torch.data.synthetic import make_cxr_clients

    clients = make_cxr_clients(seed=0, n_clients=5, train_per_client=8,
                               val_per_client=6, test_per_client=6,
                               image_size=32)
    for codec in ("identity", "int8"):
        out = {}
        for device in ("cpu", dev):
            strat, state, epoch, _ = sflv3(DENSENET_MINI, clients, 4, device,
                                           fuse=True, codec=codec)
            out[torch_type(device)] = (
                np.asarray(epoch.losses).reshape(epoch.steps, -1),
                np.concatenate(strat.scores_all(state,
                                                [c.test for c in clients])))
        dl = np.abs(out["cpu"][0] - out["cuda"][0]).max(axis=1)
        ds = float(np.abs(out["cpu"][1] - out["cuda"][1]).max())
        log(f"  mini 32^2 over {codec}: |loss card - cpu| by step "
            f"{dl.tolist()}, |score card - cpu| {ds:.3g}")
        if not np.isfinite(out["cuda"][0]).all():
            fail(f"non-finite losses on the card over {codec}")
        if codec == "identity" and not (dl.max() <= 1e-4 and ds <= 1e-4):
            fail("the card's SplitFedv3 run disagrees with the CPU's")
        if dl[0] > 1e-4:        # step 1: the same params on both sides
            fail(f"the card's first-step losses over {codec} disagree "
                 "with the CPU's")

    # the private step (DP-SGD through vmap(grad), K5/K6; K3 or K1/K2
    # under vmap on the int8 link), deterministic: noise 0, C = 1.  Every
    # step is held over the identity link, the first over int8 (as above)
    priv = dict(noise_multiplier=0.0, clip_norm=1.0, cut_noise_std=0.0)
    for codec, fuse in [("identity", True), ("int8", True), ("int8", False)]:
        out = {}
        for device in ("cpu", dev):
            _, _, epoch, _ = sflv3(DENSENET_MINI, clients[:3], 2, device,
                                   fuse=fuse, codec=codec, privacy=priv,
                                   n_train=4)
            out[torch_type(device)] = np.asarray(epoch.losses).reshape(
                epoch.steps, -1)
        dl = np.abs(out["cpu"] - out["cuda"]).max(axis=1)
        log(f"  mini 32^2 private (noise 0, C 1) over {codec}"
            f"{'' if codec == 'identity' else (' fused' if fuse else ' unfused')}"
            f": |loss card - cpu| by step {dl.tolist()}")
        held = dl if codec == "identity" else dl[:1]
        if not np.isfinite(out["cuda"]).all() or held.max() > 1e-4:
            fail("the card's private step disagrees with the CPU's")


def torch_type(device) -> str:
    import torch
    return torch.device(device).type


def main_data(steps):
    """The 5 synthetic hospitals of the main paths at 224^2."""
    from repro_torch.data.synthetic import make_cxr_clients

    t0 = time.perf_counter()
    clients = make_cxr_clients(seed=0, n_clients=5,
                               train_per_client=steps * BATCH,
                               val_per_client=BATCH, test_per_client=BATCH,
                               image_size=224)
    log(f"  data: 5 hospitals x {steps * BATCH} train images at 224^2 "
        f"({time.perf_counter() - t0:.1f} s)")
    return clients


def path_kernels():
    from repro_torch.kernels.act_compress import act_compress as AC
    from repro_torch.kernels.cut_fuse import cut_fuse as CF
    from repro_torch.kernels.dp_clip import dp_clip as DC
    return {"K1": AC.QUANTIZE, "K2": AC.DEQUANTIZE, "K3": CF.ROUNDTRIP,
            "K4": CF.NOISE_ROUNDTRIP, "K5": DC.SQNORMS,
            "K6": DC.SCALE_ACCUM}


def run_path(label, clients, dev, fuse, privacy=None, n_train=None):
    """One epoch of the main path; returns (strategy, state, per-step
    losses, launches of each kernel in this run)."""
    import numpy as np
    import torch

    from repro_torch.configs.paper_models import DENSENET121_PAPER

    kernels = path_kernels()
    torch.cuda.reset_peak_memory_stats()
    before = {n: k.launches for n, k in kernels.items()}
    step_s = []
    strat, state, epoch, tr = sflv3(DENSENET121_PAPER, clients, BATCH, dev,
                                    fuse, step_seconds=step_s,
                                    privacy=privacy, n_train=n_train)
    counts = {n: k.launches - before[n] for n, k in kernels.items()}
    losses = np.asarray(epoch.losses).reshape(epoch.steps, -1)
    log(f"  sflv3_ac {label}: {epoch.steps} steps, step seconds "
        f"{[round(x, 4) for x in step_s]}, step-1 losses "
        f"{losses[0].tolist()}")
    log(f"    launches {' '.join(f'{n} {c}' for n, c in counts.items())}; "
        f"transport {json.dumps(tr.summary())}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not np.isfinite(losses).all():
        fail(f"non-finite losses in the {label} run")
    return strat, state, losses, counts


def evaluate(strat, state, clients):
    val = strat.val_loss(state, clients)
    metrics = strat.evaluate(state, clients)
    log(f"  val_loss {val:.6f}; evaluate {json.dumps(metrics)}")
    if not math.isfinite(val) or not all(map(math.isfinite,
                                             metrics.values())):
        fail("non-finite validation loss or metrics")


def reset_launches():
    for k in path_kernels().values():
        k.launches = 0


def main_path(dev, clients, profile):
    """Phase 5: the non-private path, unfused (K1, K2) then fused (K3)."""
    import numpy as np

    reset_launches()
    runs = {}
    for fuse in (False, True):
        strat, state, runs[fuse], _ = run_path(
            "fused (K3)" if fuse else "unfused (K1, K2)", clients, dev, fuse)
    evaluate(strat, state, clients)     # the fused strategy, the default
    launches = {n: k.launches for n, k in path_kernels().items()
                if n in ("K1", "K2", "K3")}
    if not np.array_equal(runs[True][0], runs[False][0]):
        fail("first-step losses differ between the fused and unfused runs")
    if not all(launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    if profile:
        profile_step(strat, state, clients, BATCH, "fused")
    return launches


def private_path(dev, clients, profile):
    """Phase 6: DP-SGD + cut-layer noise over the int8 link, unfused (K1, K2
    + the masked add, K5, K6) then fused (K4, K5, K6), 2 steps each; then
    cut-layer noise alone (DP off), one K4 launch per step."""
    import numpy as np

    n = len(clients)
    reset_launches()
    runs = {}
    expect = {False: {"K1": 1, "K2": 1, "K5": 1, "K6": 1},
              True: {"K4": 1, "K5": 1, "K6": 1}}
    for fuse in (False, True):
        label = ("private fused (K4, K5, K6)" if fuse
                 else "private unfused (K1, K2 + add, K5, K6)")
        strat, state, runs[fuse], counts = run_path(
            label, clients, dev, fuse, PRIVACY, 2 * BATCH)
        report = strat.privacy_report()
        log(f"    privacy_report {json.dumps(report)}")
        if len(report) != n or not all(
                math.isfinite(r["epsilon"]) and r["epsilon"] > 0
                for r in report):
            fail("privacy_report lacks a finite epsilon for a hospital")
        # every hospital, every step: one launch of each of its kernels
        want = {k: expect[fuse].get(k, 0) * n * len(runs[fuse])
                for k in counts}
        if counts != want:
            fail(f"{label}: launches {counts}, expected {want}")
    evaluate(strat, state, clients)
    if not np.array_equal(runs[True][0], runs[False][0]):
        fail("first-step losses differ between the private fused and "
             "unfused runs")
    _, _, losses, counts = run_path(
        "cut noise only (K4)", clients, dev, True,
        dict(cut_noise_std=PRIVACY["cut_noise_std"], seed=0), 2 * BATCH)
    if counts["K4"] != len(losses) or counts["K5"] or counts["K6"]:
        fail(f"cut noise alone should launch K4 once per step: {counts}")
    launches = {k: v.launches for k, v in path_kernels().items()
                if k in ("K4", "K5", "K6")}
    if not all(launches.values()):
        fail(f"a kernel of the private path never launched: {launches}")
    if profile:
        profile_step(strat, state, clients, BATCH, "private fused")
    return launches


# ---------------------------------------------------------------------------
# phases 4 and 7: the LM serving slice
# ---------------------------------------------------------------------------

def lm_kernels():
    from repro_torch.kernels.cut_fuse import cut_fuse as CF
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.ssd_scan import ssd_scan as SS
    return {"K3": CF.ROUNDTRIP, "K7": FA.FLASH, "K8": SS.SSD_CHUNK}


def lm_tokens(vocab, seq, device):
    """LM_BATCH prompts of ``seq`` tokens, one from each of LM_BATCH
    synthetic clients (``lm_clients``, seed 0)."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import lm_clients
    return torch.from_numpy(np.concatenate(
        lm_clients(0, vocab, LM_BATCH, 1, seq))).to(device)


def lm_small_against_cpu(dev):
    """SmolLM's and Mamba2's SMOKE configs in f32, on the card (K7, K8) and
    on the CPU (their plain versions) from the same params: the scoring
    logits within 5e-5 of their largest magnitude and the losses within
    1e-5 (the CPU tests hold 1e-5 between XLA and ATen on one CPU; cuBLAS
    sums in other tile orders), and equal greedy tokens."""
    import dataclasses

    import torch

    from repro_torch.configs import mamba2_130m, smollm_135m
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.engine import greedy_generate
    from repro_torch.tree import tree_map

    kernels = lm_kernels()
    for cfg in (smollm_135m.SMOKE, mamba2_130m.SMOKE):
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
        model = TransformerLM.build(cfg)
        params = model.init_params(torch.Generator().manual_seed(0), "cpu")
        out = {}
        for device in ("cpu", dev):
            p = tree_map(lambda t: t.to(device), params)
            toks = lm_tokens(cfg.vocab_size, 65, device)
            before = {k: v.launches for k, v in kernels.items()}
            logits, _, _ = model.apply(p, toks[:, :-1], use_pallas=True)
            loss = float(model.loss(p, {"tokens": toks}, train=False,
                                    use_pallas=True))
            gen = greedy_generate(model, p, toks[:, :16], max_new=8,
                                  max_len=24, cache_dtype=torch.float32)
            out[torch_type(device)] = (logits.cpu(), loss, gen.cpu(), {
                k: v.launches - before[k] for k, v in kernels.items()})
        (lc, fc, gc, _), (lg, fg, gg, n) = out["cpu"], out["cuda"]
        dl = max_err(lg, lc)
        scale = float(lc.abs().max())
        log(f"  {cfg.name} f32 at {LM_BATCH} x 64: |logits card - cpu| {dl:.3g} "
            f"(bar {5e-5 * scale:.3g}), losses {fg:.7f} / {fc:.7f}, greedy "
            f"tokens equal {torch.equal(gg, gc)}, launches on the card {n}")
        if not (dl <= 5e-5 * scale and abs(fg - fc) <= 1e-5
                and torch.equal(gg, gc)):
            fail(f"the card's {cfg.name} disagrees with the CPU's")


def timed(fn):
    """(result, host seconds) of one call between two synchronisations."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# Bars of the whole-model comparison kernel path vs plain path (phase 7),
# by compute dtype: (relative RMS difference of the logits, max |diff| as a
# share of the largest logit, or None: printed, not held).  Only summation
# order differs between the paths, but a random-weight model 24-30 layers
# deep amplifies it, and in bf16 (rounding at every op) Mamba2-130M's
# logits decorrelate at some positions: on the CPU, with no CUDA kernel
# (the kernel path takes the plain chunk function there), Mamba2-130M at
# 2 x 256 tokens differs by a relative RMS of 3e-5 in f32 and 0.043 in bf16
# (max 0.63 of a largest logit of 5.3); on the H100 at 4 x 2048 tokens by
# 9.8e-5 in f32 and 0.084-0.113 in bf16 (max 2.1-2.7 of 6).  So the f32
# comparison is the precise one; in bf16 the logits are held only against
# a gross error (unrelated logits differ by a relative RMS of about 1.4),
# and the bf16 eval losses within 1e-2.
LOGIT_BARS = {"float32": (1e-3, 0.01), "bfloat16": (0.5, None)}


def logits_agree(label, a, b) -> bool:
    """Hold logits ``a`` against ``b`` by the bars of their dtype."""
    import torch
    rel_bar, max_bar = LOGIT_BARS[str(b.dtype)[6:]]
    a, b = a.float(), b.float()
    rel = float((a - b).norm() / b.norm())
    mx, scale = max_err(a, b), float(b.abs().max())
    ok = bool(torch.isfinite(a).all()) and rel <= rel_bar and (
        max_bar is None or mx <= max_bar * scale)
    log(f"    {label}: logits relative RMS diff {rel:.3g} (bar {rel_bar:g}), "
        f"max |diff| {mx:.4g} of a largest {scale:.4g}"
        + ("" if max_bar is None else f" (bar {max_bar:g} of it)")
        + ("" if ok else "  FAILS"))
    return ok


def lm_path(dev, profile):
    """Phase 7: SmolLM-135M (K7) and Mamba2-130M (K8) at their published
    widths, random weights from seed 0.  Scoring in bf16 (the configs'
    compute dtype): LM_BATCH prompts of LM_SEQ tokens through ``apply`` and
    ``loss`` with use_pallas True, then with the int8 cut link (K3 once per
    forward) at ``cut_layer`` 4, each held against the same call with
    use_pallas False: losses within 1e-2, logits by ``LOGIT_BARS``; then
    ``apply`` in f32 compute, kernels against plain by the f32 bars (the
    precise comparison).
    Generation: ``greedy_generate`` over the caches (no kernel), its
    prefill logits held to the cacheless forward's last position.  Returns
    the launches of K7 and K8 in this phase."""
    import dataclasses

    import torch

    from repro_torch.configs import mamba2_130m, smollm_135m
    from repro_torch.kernels.cut_fuse.ops import roundtrip_boundary
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.engine import greedy_generate, make_prefill_step

    kernels = lm_kernels()
    for k in kernels.values():
        k.launches = 0
    for cfg, key in ((smollm_135m.CONFIG, "K7"), (mamba2_130m.CONFIG, "K8")):
        per = cfg.n_layers          # one launch per layer and forward
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = TransformerLM.build(cfg)
        params = model.init_params(torch.Generator().manual_seed(0), dev)
        toks = lm_tokens(cfg.vocab_size, LM_SEQ + 1, dev)
        prompts = toks[:, :LM_SEQ]
        log(f"  {cfg.name}: params and {LM_BATCH} x {LM_SEQ + 1} tokens "
            f"in {time.perf_counter() - t0:.1f} s")

        def call(label, fn, want):
            """One call; its launches must be ``want`` (K3, K7, K8)."""
            before = {k: v.launches for k, v in kernels.items()}
            out, sec = timed(fn)
            n = {k: v.launches - before[k] for k, v in kernels.items()}
            log(f"    {label}: {sec * 1e3:.3f} ms, launches {n}")
            if n != want:
                fail(f"{cfg.name} {label}: launches {n}, expected {want}")
            return out, sec

        none = {"K3": 0, "K7": 0, "K8": 0}
        fwd = {**none, key: per}
        link = {**fwd, "K3": 1}
        res = {}
        for pallas in (True, False):
            want = fwd if pallas else none
            tag = "kernels" if pallas else "plain"
            for rep in (1, 2):      # the second is the steady time
                (logits, _, _), sec = call(
                    f"apply use_pallas={pallas} ({rep})",
                    lambda: model.apply(params, prompts,
                                        use_pallas=pallas), want)
            loss, _ = call(f"loss use_pallas={pallas}", lambda: model.loss(
                params, {"tokens": toks}, train=False, use_pallas=pallas),
                want)
            (llog, _, _), _ = call(
                f"apply over the int8 link, use_pallas={pallas}",
                lambda: model.apply(params, prompts, use_pallas=pallas,
                                    boundary_fn=roundtrip_boundary),
                link if pallas else {**none, "K3": 1})
            lloss, _ = call(f"loss over the int8 link, use_pallas={pallas}",
                            lambda: model.loss(params, {"tokens": toks},
                                               train=False,
                                               use_pallas=pallas,
                                               boundary_fn=roundtrip_boundary),
                            link if pallas else {**none, "K3": 1})
            res[tag] = (logits, float(loss), llog, float(lloss), sec)
            log(f"    scoring {tag}: {sec * 1e3:.3f} ms per forward, "
                f"{LM_BATCH * LM_SEQ / sec:,.0f} tokens/s; eval loss "
                f"{float(loss):.6f}, over the int8 link {float(lloss):.6f}")
        (lk, fk, llk, flk, _), (lp, fp, llp, flp, _) = res["kernels"], \
            res["plain"]
        log(f"    kernels vs plain: loss diff {abs(fk - fp):.3g}, over the "
            f"link {abs(flk - flp):.3g} (bar 1e-2)")
        ok = [logits_agree("kernels vs plain, bf16", lk, lp),
              logits_agree("kernels vs plain over the link, bf16", llk, llp),
              abs(fk - fp) <= 1e-2, abs(flk - flp) <= 1e-2]
        del lk, lp, llk, llp, res
        m32 = TransformerLM.build(dataclasses.replace(
            cfg, compute_dtype=torch.float32))
        (lk, _, _), _ = call("apply in f32, use_pallas=True", lambda: m32.apply(
            params, prompts, use_pallas=True), fwd)
        (lp, _, _), _ = call("apply in f32, use_pallas=False",
                             lambda: m32.apply(params, prompts), none)
        ok.append(logits_agree("kernels vs plain, f32", lk, lp))
        del lk, lp
        if not all(ok):
            fail(f"{cfg.name}: the kernel path disagrees with the plain one")

        prompt = prompts[:, :GEN_PROMPT].contiguous()
        max_len = GEN_PROMPT + GEN_NEW
        out, sec = call(f"greedy_generate {LM_BATCH} x {GEN_PROMPT} + "
                        f"{GEN_NEW}", lambda: greedy_generate(
                            model, params, prompt, GEN_NEW, max_len), none)
        log(f"    generation: {LM_BATCH * GEN_NEW / sec:,.1f} new tokens/s "
            f"({sec:.3f} s with the prefill); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if out.shape != (LM_BATCH, GEN_NEW) or out.dtype != torch.int32 or \
                not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
            fail(f"{cfg.name}: generated tokens malformed")
        last, _ = make_prefill_step(model, max_len)(params,
                                                    {"tokens": prompt})
        if not logits_agree("prefill through the cache vs the cacheless "
                            "forward's last position", last,
                            model.apply(params, prompt)[0][:, -1]):
            fail(f"{cfg.name}: prefill disagrees with the full forward")
        if profile:
            profile_call(lambda: model.apply(params, prompts,
                                             use_pallas=True),
                         f"{cfg.name} scoring forward ({LM_BATCH} x "
                         f"{LM_SEQ})", LM_KERNEL_GROUPS)
        del params, toks, prompts, out
        torch.cuda.empty_cache()
    launches = {k: kernels[k].launches for k in ("K7", "K8")}
    log(f"  launches in phase 7: {launches}, K3 {kernels['K3'].launches}")
    if not all(launches.values()):
        fail(f"a kernel of the LM path never launched: {launches}")
    return launches


# kernel-name fragments of each share that --profile reports
KERNEL_GROUPS = (
    ("hand kernels K1-K6", ("quantize_kernel", "roundtrip_kernel",
                            "sqnorm_", "scale_accum_kernel")),
    ("convolution", ("conv", "xmma", "implicit_gemm", "wgrad", "dgrad",
                     "fprop", "gemm", "cudnn")),
    ("group norm", ("GroupNorm", "group_norm", "RowwiseMoments",
                    "ComputeInternalGradients", "Compute1dBackward",
                    "ComputeFusedParams")),
    ("cat / copy", ("CatArrayBatchedCopy", "copy", "cat")),
)


# the same for one LM scoring forward (phase 7)
LM_KERNEL_GROUPS = (
    ("hand kernels K3, K7, K8", ("flash_fwd_f32_kernel",
                                 "flash_fwd_bf16_kernel", "ssd_chunk_kernel",
                                 "roundtrip_kernel")),
    ("matmul", ("nvjet", "gemm", "xmma", "cutlass", "splitK")),
    ("softmax / reductions", ("softmax", "reduce", "Reduce", "cumsum",
                              "scan")),
    ("cat / copy", ("CatArrayBatchedCopy", "copy", "cat")),
    ("elementwise", ("elementwise_kernel",)),
)


def profile_step(strat, state, clients, batch, label):
    """Device time of one more SplitFedv3 step (after a warm one)."""
    import numpy as np

    data = [{k: v[:batch] for k, v in c.train.items()} for c in clients]
    strat.run_epoch(state, data, np.random.default_rng(2), batch)  # warm
    profile_call(lambda: strat.run_epoch(state, data,
                                         np.random.default_rng(3), batch),
                 f"{label} step", KERNEL_GROUPS)


def profile_call(fn, label, kernel_groups):
    """Device time of one call of ``fn``, by kernel and by group, and the
    share of its wall time the device was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if getattr(e, "device_type", None) == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if not total:
        log("  profile: no device time recorded (not measured)")
        return
    log(f"  profile of one {label}: kernels {total:.3f} ms on the "
        f"device, {wall_ms:.3f} ms wall under the profiler, busy "
        f"{100 * total / wall_ms:.1f}%")
    groups = dict.fromkeys([g for g, _ in kernel_groups] + ["other"], 0.0)
    for e in kernels:
        name = next((g for g, frags in kernel_groups
                     if any(f in e.key for f in frags)), "other")
        groups[name] += e.self_device_time_total / 1e3
    log("    by group: " + ", ".join(
        f"{g} {ms:.3f} ms ({100 * ms / total:.1f}%)"
        for g, ms in groups.items()))
    for e in kernels[:12]:
        ms = e.self_device_time_total / 1e3
        log(f"    {ms:9.3f} ms {100 * ms / total:5.1f}%  x{e.count:<5d} "
            f"{e.key[:90]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3,
                    help="SplitFedv3 steps per main-path run (>= 2)")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if args.steps < 2:
        fail("--steps must be at least 2")

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    dev = torch.device("cuda", 0)

    log("phase 1: card")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("phase 2: build")
    t0 = time.perf_counter()
    libs = build.build()
    log(f"  built {[p.name for p in libs]} in "
        f"{time.perf_counter() - t0:.1f} s")

    log("phase 3: kernels against their plain versions")
    table = check_kernels(dev)
    table.update(check_lm_kernels(dev, torch.Generator(device=dev)
                                  .manual_seed(1)))

    log("phase 4: the slices at small size, card against CPU")
    small_against_cpu(dev)
    lm_small_against_cpu(dev)

    log("phase 5: the main path, DenseNet-121 at 224^2")
    clients = main_data(args.steps)
    launches = main_path(dev, clients, args.profile)

    log("phase 6: the private main path, DenseNet-121 at 224^2")
    launches.update(private_path(dev, clients, args.profile))
    del clients

    log("phase 7: LM serving, SmolLM-135M and Mamba2-130M")
    launches.update(lm_path(dev, args.profile))
    for key, n in launches.items():
        table[key]["launches"] = n

    log(card)
    log(json.dumps({"kernels": list(table.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
