"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--steps N] [--profile]

Phases, in order; any failure exits nonzero before the last line:
  1. print the card's name and power limit (``nvidia-smi``);
  2. build the cut-layer kernels from ``src/repro_torch/kernels/csrc``;
  3. hold K1 (quantize), K2 (dequantize) and K3 (fused roundtrip) bit for
     bit against their plain PyTorch versions on the card, in f32 and bf16,
     at the main path's shape (250,880 x 160) and a ragged one (7 x 96),
     check K3 == K2(K1(x)), and time each with CUDA events beside its
     bound;
  4. train SplitFedv3 (``sflv3_ac``) on DenseNet-121-mini at 32^2 on the
     card and on the CPU from the same start, and hold the card's losses
     and scores against the CPU's plain path over an identity link (the
     int8 link's difference is printed);
  5. the main path: SplitFedv3 on DenseNet-121 at 224^2, 5 synthetic
     hospitals, batch 16 per hospital, over ``Transport("int8")`` fused
     (K3) and unfused (K1, K2), then ``val_loss`` and
     ``evaluate``; the first step's losses of the two runs must be
     bit-identical and every launch count of the path nonzero;
  6. print one JSON line ``{"kernels": [...]}``, then the last line
     ``{"ok": true, "device": {...}}``.

``--profile`` adds one profiled fused step (``torch.profiler``) and prints
the device time by kernel.  The script imports nothing of JAX or of the
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
# K2 convert, multiply; K3 both
OPS_PER_ELEM = {"K1": 5, "K2": 2, "K3": 7}


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

    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    for shape in [(MAIN_ROWS, MAIN_D), (7, 96)]:
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, device=dev, generator=gen) * 3).to(dt)
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
            log(f"  {tuple(shape)} {str(dt)[6:]}: K1 {k1}  K2 {k2}  K3 {k3}"
                f"  K3==K2(K1) {composed}")
            if not (k1 and k2 and k3 and composed):
                fail(f"kernel disagrees with its plain version at {shape} "
                     f"{dt}")

    # time at the main path's shape and dtype (f32): 160 MB in, so every
    # launch finds its input outside the 50 MB L2
    x = torch.randn((MAIN_ROWS, MAIN_D), device=dev, generator=gen) * 3
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
    ]
    table = {}
    for key, name, replaces, kern, plain, nin, nout in rows:
        # plain, kernel, kernel, plain: the mean of each pair
        p0, k0, k1_, p1 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                           cuda_ms(plain))
        b_ms, b_by = bound(key, t, MAIN_D, nin, nout)
        table[key] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cut_layer.cu",
            "replaces": replaces, "launches": 0,
            "max_abs_err": err[key], "bit_equal": err[key] == 0.0,
            "ms": (k0 + k1_) / 2, "plain_ms": (p0 + p1) / 2,
            "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes per-row absmax int8
            "library_ms": None,
        }
        log(f"  {key} {name}: {table[key]['ms']:.4f} ms (plain "
            f"{table[key]['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by "
            f"{b_by}) at {t} x {MAIN_D} f32")
    return table


# ---------------------------------------------------------------------------
# phases 4 and 5: the SplitFedv3 slice
# ---------------------------------------------------------------------------

def sflv3(cfg, clients, batch, device, fuse, seed=0, step_seconds=None,
          codec="int8"):
    """Build the slice as a user would and train one epoch; with a list
    ``step_seconds`` each step is timed on the host clock between two
    device synchronisations."""
    import numpy as np
    import torch

    from repro_torch import optim as O
    from repro_torch.core.partition import cnn_adapter
    from repro_torch.core.strategies import make_strategy
    from repro_torch.models.cnn import build_densenet
    from repro_torch.wire import Transport

    adapter = cnn_adapter(build_densenet(cfg))
    transport = Transport(codec, fuse=fuse, device=device)
    strat = make_strategy("sflv3_ac", adapter, lambda: O.adam(1e-4),
                          len(clients), transport=transport, device=device)
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
    state, epoch = strat.run_epoch(state, [c.train for c in clients],
                                   np.random.default_rng(1), batch)
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


def torch_type(device) -> str:
    import torch
    return torch.device(device).type


def main_path(dev, steps, profile):
    import numpy as np
    import torch

    from repro_torch.configs.paper_models import DENSENET121_PAPER
    from repro_torch.data.synthetic import make_cxr_clients
    from repro_torch.kernels.act_compress import act_compress as AC
    from repro_torch.kernels.cut_fuse import cut_fuse as CF

    batch = 16
    t0 = time.perf_counter()
    clients = make_cxr_clients(seed=0, n_clients=5,
                               train_per_client=steps * batch,
                               val_per_client=batch, test_per_client=batch,
                               image_size=224)
    log(f"  data: 5 hospitals x {steps * batch} train images at 224^2 "
        f"({time.perf_counter() - t0:.1f} s)")

    kernels = (AC.QUANTIZE, AC.DEQUANTIZE, CF.ROUNDTRIP)
    for k in kernels:
        k.launches = 0
    runs = {}
    for fuse in (False, True):
        torch.cuda.reset_peak_memory_stats()
        before = [k.launches for k in kernels]
        step_s = []
        strat, state, epoch, tr = sflv3(DENSENET121_PAPER, clients, batch,
                                        dev, fuse, step_seconds=step_s)
        counts = [k.launches - b for k, b in zip(kernels, before)]
        losses = np.asarray(epoch.losses).reshape(epoch.steps, -1)
        runs[fuse] = losses
        label = "fused (K3)" if fuse else "unfused (K1, K2)"
        log(f"  sflv3_ac {label}: {epoch.steps} steps, step seconds "
            f"{[round(x, 4) for x in step_s]}, step-1 losses "
            f"{losses[0].tolist()}")
        log(f"    launches K1 {counts[0]} K2 {counts[1]} K3 {counts[2]}; "
            f"transport {json.dumps(tr.summary())}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not np.isfinite(losses).all():
            fail(f"non-finite losses in the {label} run")
    # the fused strategy (the default) is the one evaluated
    val = strat.val_loss(state, clients)
    metrics = strat.evaluate(state, clients)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in zip(("K1", "K2", "K3"),
                                                   kernels)}
    log(f"  val_loss {val:.6f}; evaluate {json.dumps(metrics)}")
    if not math.isfinite(val) or not all(map(math.isfinite,
                                             metrics.values())):
        fail("non-finite validation loss or metrics")
    if not np.array_equal(runs[True][0], runs[False][0]):
        fail("first-step losses differ between the fused and unfused runs")
    if not all(launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    if profile:
        profile_step(strat, state, clients, batch)
    return launches


# kernel-name fragments of each share that --profile reports
KERNEL_GROUPS = (
    ("cut-layer K1-K3", ("quantize_kernel", "roundtrip_kernel")),
    ("convolution", ("conv", "xmma", "implicit_gemm", "wgrad", "dgrad",
                     "fprop", "gemm", "cudnn")),
    ("group norm", ("GroupNorm", "group_norm", "RowwiseMoments",
                    "ComputeInternalGradients", "Compute1dBackward",
                    "ComputeFusedParams")),
    ("cat / copy", ("CatArrayBatchedCopy", "copy", "cat")),
)


def profile_step(strat, state, clients, batch):
    """Device time of one more fused step, by kernel and by group, and
    the share of the step's wall time the device was busy."""
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
    log(f"  profile of one fused step: kernels {total:.3f} ms on the "
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
    launches = main_path(dev, args.steps, args.profile)
    for key, n in launches.items():
        table[key]["launches"] = n

    log(card)
    log(json.dumps({"kernels": list(table.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
