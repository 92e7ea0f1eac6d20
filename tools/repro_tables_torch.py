"""The paper's comparison (Tables 2/3/4/5/6) on the PyTorch port: the
counterpart of ``benchmarks/repro_tables.py``, with the same method grid
(``ROWS``), plans and JSON fields, on the synthetic 5-hospital non-IID CXR
task.  Every row trains with best-validation-loss model selection (§3.2)
and records the per-epoch wall time (Table 3), the analytic communication
(Table 4) and the FLOPs counted by ``FlopCounterMode`` (Tables 5/6).

    PYTHONPATH=src python tools/repro_tables_torch.py --out DIR [--quick]
        [--arch densenet-mini|unet-mini] [--device cpu|cuda]
        [--engine compiled|stepwise] [--precision fp32|bf16]

Writes ``DIR/repro_{arch}.json``, one record per row and seed, each naming
the device, engine and precision it ran on.  The default device is the
CUDA card, the default engine the compiled one (as ``make_strategy``'s).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from repro_torch import optim as O
from repro_torch.configs.paper_models import DENSENET_MINI, UNET_MINI
from repro_torch.core.comm import comm_per_epoch
from repro_torch.core.flops import flops_per_epoch, segment_fwd_flops
from repro_torch.core.partition import cnn_adapter
from repro_torch.core.strategies import make_strategy
from repro_torch.data.synthetic import make_cxr_clients
from repro_torch.device import resolve_device
from repro_torch.models.cnn import build_densenet, build_unet
from repro_torch.tree import tree_map

# the paper's Table-2 method grid (label, strategy key, nls?)
ROWS = [
    ("Centralized",  "centralized", False),
    ("FL",           "fl",          False),
    ("SL_LS_AC",     "sl_ac",       False),
    ("SL_LS_AM",     "sl_am",       False),
    ("SL_NLS_AC",    "sl_ac",       True),
    ("SL_NLS_AM",    "sl_am",       True),
    ("SFLv2_LS_AC",  "sflv2_ac",    False),
    ("SFLv2_NLS_AC", "sflv2_ac",    True),
    ("SFLv3_LS_AC",  "sflv3_ac",    False),
    ("SFLv3_NLS_AC", "sflv3_ac",    True),
    ("SFLv1_LS_AC",  "sflv1_ac",    False),   # bonus (paper excluded SFLv1)
]

PLANS = {"densenet-mini": {"epochs": 10, "quick_epochs": 2, "batch": 8,
                           "lr": 3e-4},
         "unet-mini": {"epochs": 5, "quick_epochs": 2, "batch": 8,
                       "lr": 3e-4}}


def build_model(arch: str, nls: bool):
    if arch == "densenet-mini":
        return cnn_adapter(build_densenet(DENSENET_MINI, nls=nls))
    if arch == "unet-mini":
        return cnn_adapter(build_unet(UNET_MINI, nls=nls))
    raise KeyError(arch)


def device_label(device: torch.device) -> str:
    """The card's name and power limit, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (out.stdout.strip().splitlines() or
            [torch.cuda.get_device_name(device)])[0]


_CACHE: dict = {}       # strategies and FLOP counts, reused across seeds


def run_method(label, method, nls, arch, clients, epochs, batch_size, lr,
               device, seed=0, engine="compiled", precision="fp32"):
    """One row: train, select by validation loss, evaluate, account."""
    key = (label, arch, batch_size)
    if key not in _CACHE:
        _CACHE[key] = make_strategy(method, build_model(arch, nls),
                                    lambda: O.adam(lr), len(clients),
                                    engine=engine, precision=precision,
                                    device=device)
    strat = _CACHE[key]
    adapter = strat.adapter
    state = strat.setup(seed)
    rng = np.random.default_rng(seed)
    data = [c.train for c in clients]

    best = {"val_loss": float("inf"), "state": None}
    epoch_times = []
    for ep in range(epochs):
        t0 = time.perf_counter()
        state, log = strat.run_epoch(state, data, rng, batch_size)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_times.append(time.perf_counter() - t0)
        vl = strat.val_loss(state, clients, batch_size)
        if vl < best["val_loss"]:
            # updates make new tensors, so a copy of the containers keeps
            # this epoch's state
            best = {"val_loss": vl, "state": tree_map(lambda x: x, state)}
        print(f"    ep{ep} loss={log.mean_loss:.3f} val={vl:.3f} "
              f"t={epoch_times[-1]:.2f}s", flush=True)

    metrics = strat.evaluate(best["state"], clients, "test", batch_size)
    n_train = [len(d["label"]) for d in data]
    n_val = [len(c.val["label"]) for c in clients]
    eb = {k: v[:batch_size] for k, v in data[0].items()}
    comm = comm_per_epoch(method, adapter, eb, n_train, n_val, batch_size)
    fkey = ("flops", arch, nls, batch_size)
    if fkey not in _CACHE:
        _CACHE[fkey] = segment_fwd_flops(adapter, eb)
    fl = flops_per_epoch(method, adapter, eb, n_train, batch_size,
                         seg_fwd=_CACHE[fkey])
    return {
        "label": label, "method": method, "nls": nls, "arch": arch,
        **{k: round(float(v), 4) for k, v in metrics.items()},
        "best_val_loss": round(float(best["val_loss"]), 4),
        # the first epoch includes warm-up; steady state = median of rest
        "epoch_time_s": round(float(np.median(epoch_times[1:])
                                    if len(epoch_times) > 1
                                    else epoch_times[0]), 2),
        "epoch_times_s": epoch_times,
        "comm_gb": round(comm.gb, 6),
        "comm_breakdown": {k: int(v) for k, v in comm.breakdown.items()},
        "server_tflops": round(fl.server_tflops, 6),
        "avg_client_tflops": round(fl.avg_client_tflops, 6),
        "averaging_mflops": round(fl.averaging_mflops, 6),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--arch", default=None, choices=list(PLANS))
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--engine", default="compiled",
                    choices=["compiled", "stepwise"])
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    device = resolve_device(args.device)
    where = device_label(device)
    print(f"device: {where}, engine {args.engine}, precision "
          f"{args.precision}", flush=True)

    # unequal hospital volumes, like the paper's 3772/1150/1816/880/1090
    sizes = [40, 16, 24, 16, 24] if args.quick else [160, 80, 120, 64, 96]
    clients = make_cxr_clients(seed=0, train_per_client=sizes,
                               val_per_client=60, test_per_client=60,
                               image_size=32)
    for arch in [args.arch] if args.arch else list(PLANS):
        plan = PLANS[arch]
        epochs = plan["quick_epochs"] if args.quick else plan["epochs"]
        out_path = os.path.join(args.out, f"repro_{arch}.json")
        results = []
        if os.path.exists(out_path):            # resume partial runs
            with open(out_path) as f:
                results = json.load(f)
        done = {(r["label"], r.get("seed", 0)) for r in results}
        for label, method, nls in ROWS:
            for seed in range(1 if args.quick else args.seeds):
                if (label, seed) in done:
                    continue
                print(f"== {arch} {label} seed{seed}", flush=True)
                t0 = time.perf_counter()
                rec = run_method(label, method, nls, arch, clients, epochs,
                                 plan["batch"], plan["lr"], device, seed,
                                 args.engine, args.precision)
                rec.update(seed=seed, device=where, engine=args.engine,
                           precision=args.precision,
                           wall_s=round(time.perf_counter() - t0, 1))
                results.append(rec)
                print(f"   -> auroc={rec['auroc']} auprc={rec['auprc']} "
                      f"f1={rec['f1']} kappa={rec['kappa']} "
                      f"comm={rec['comm_gb']}GB", flush=True)
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
