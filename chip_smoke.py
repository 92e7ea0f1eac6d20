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
     6,948,609 f32) and a ragged small one; time each with CUDA events
     beside its bound and, for K5/K6, one PyTorch call;
  4. train SplitFedv3 (``sflv3_ac``) on DenseNet-121-mini at 32^2 on the
     card and on the CPU from the same start, and hold the card's losses
     and scores against the CPU's plain path over an identity link (the
     int8 link's difference is printed); then the same privately (DP-SGD
     with noise 0 and C = 1: deterministic), losses within 1e-4;
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
  7. print one JSON line ``{"kernels": [...]}``, then the last line
     ``{"ok": true, "device": {...}}``.

``--profile`` adds one profiled fused step of each main path
(``torch.profiler``) and prints the device time by kernel.  The script imports nothing of JAX or of the
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
MAIN_ROWS, MAIN_D = 80 * 56 * 56, 160   # the cut tensor of 5 x 16 images
# operations per element of each kernel: K1 abs, max, divide, round, clamp;
# K2 convert, multiply; K3 both; K4 K3's and the noise multiply and add;
# K5 multiply, add; K6 multiply, add
OPS_PER_ELEM = {"K1": 5, "K2": 2, "K3": 7, "K4": 9, "K5": 2, "K6": 2}
BATCH = 16                       # images per hospital and step at 224^2
PRIVACY = dict(noise_multiplier=1.0, clip_norm=1.0, cut_noise_std=0.5,
               seed=0)           # examples/private_splitfed.py's defaults
CUDA_SRC = "src/repro_torch/kernels/csrc/"


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


def bound(name: str, rows: int, d: int, in_bytes: int, out_bytes: int):
    """(bound_ms, bound_by): the larger of the bytes the function must
    move over HBM bandwidth and its operations over f32 peak."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEM[name] * rows * d / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
                               plain, None, (t, MAIN_D), nin, nout, err[key])
    del x, z, w, q, s
    table.update(check_dp_clip(dev, gen))
    return table


def timed_row(key, name, source, replaces, kern, plain, library, shape,
              nin, nout, err):
    """Time a kernel, its plain version and (if any) one library call in
    the order plain, kernel, library, library, kernel, plain; each the
    mean of its pair."""
    p0, k0 = cuda_ms(plain), cuda_ms(kern)
    l0 = cuda_ms(library) if library else None
    l1 = cuda_ms(library) if library else None
    k1, p1 = cuda_ms(kern), cuda_ms(plain)
    b_ms, b_by = bound(key, shape[0], shape[1], nin, nout)
    row = {"name": name, "route": "cuda", "source": CUDA_SRC + source,
           "replaces": replaces, "launches": 0, "max_abs_err": err,
           "ms": (k0 + k1) / 2, "plain_ms": (p0 + p1) / 2, "bound_ms": b_ms,
           "bound_by": b_by,
           "library_ms": None if library is None else (l0 + l1) / 2}
    lib = ("" if library is None
           else f", one library call {row['library_ms']:.4f} ms")
    log(f"  {key} {name}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} "
        f"ms{lib}, bound {b_ms:.4f} ms by {b_by}) at {shape[0]} x "
        f"{shape[1]} f32")
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
    table = {
        "K5": timed_row(
            "K5", "dp_sqnorms", "dp_clip.cu",
            "src/repro/kernels/dp_clip/dp_clip.py:44",
            lambda: DC.sqnorms_leaves(lt),
            lambda: sum(RD.sqnorms_ref(l) for l in leaves_real),
            lambda: torch.linalg.vecdot(big, big), (BATCH, d), 4 * n,
            4 * BATCH, err["K5"]),
        "K6": timed_row(
            "K6", "dp_scale_accum", "dp_clip.cu",
            "src/repro/kernels/dp_clip/dp_clip.py:62",
            lambda: DC.scale_accum_leaves(lt, s),
            lambda: [RD.scale_accum_ref(l, s) for l in leaves_real],
            lambda: s.reshape(1, BATCH) @ big, (BATCH, d), 4 * n + 4 * BATCH,
            4 * d, err["K6"]),
    }
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


def profile_step(strat, state, clients, batch, label):
    """Device time of one more step, by kernel and by group, and the share
    of the step's wall time the device was busy."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    data = [{k: v[:batch] for k, v in c.train.items()} for c in clients]
    strat.run_epoch(state, data, np.random.default_rng(2), batch)  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        strat.run_epoch(state, data, np.random.default_rng(3), batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if getattr(e, "device_type", None) == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if not total:
        log("  profile: no device time recorded (not measured)")
        return
    log(f"  profile of one {label} step: kernels {total:.3f} ms on the "
        f"device, {wall_ms:.3f} ms wall under the profiler, busy "
        f"{100 * total / wall_ms:.1f}%")
    groups = dict.fromkeys([g for g, _ in KERNEL_GROUPS] + ["other"], 0.0)
    for e in kernels:
        name = next((g for g, frags in KERNEL_GROUPS
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

    log("phase 4: the slice at small size, card against CPU")
    small_against_cpu(dev)

    log("phase 5: the main path, DenseNet-121 at 224^2")
    clients = main_data(args.steps)
    launches = main_path(dev, clients, args.profile)

    log("phase 6: the private main path, DenseNet-121 at 224^2")
    launches.update(private_path(dev, clients, args.profile))
    for key, n in launches.items():
        table[key]["launches"] = n

    log(card)
    log(json.dumps({"kernels": list(table.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
