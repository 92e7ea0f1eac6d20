"""The benchmark of the PyTorch and CUDA port: one run of one cell.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<name>.json``: the model, its ``family``, input size, cut and
precision) and a traffic mix (``traffic/<name>.json``: the method,
hospital volumes, batch, link, optimizer); its correctness limits are
``limits/<cell>.json``, its per-layer metrics ``metrics/<name>.py`` and
its end-to-end metrics ``end_to_end/<name>.py``, each found by its name.
Whatever belongs to one model family is in ``families/<family>/``, found
by the configuration's ``family``:

  * ``program.py``, the system under test, the only kind of module here
    that imports the port: ``build(cfg, traffic, device, precision)``,
    ``load(strat, fronts, middle)`` (a state holding the benchmark's
    weights), ``epoch(strat, state, train, rng, batch)`` (one epoch of
    every hospital; the state and the losses, [steps, hospitals or 1]),
    ``params`` and ``moments`` (a state's parameters and Adam first
    moments as the reference's flat dicts), ``val_loss``, ``dispatches``
    and ``attach_tracer``;
  * ``reference.py``, plain torch: ``hospitals(seed, cfg, traffic,
    device)`` (each hospital's ``train`` and ``val`` dicts of numpy
    arrays, keyed by what a batch holds), ``weights(seed, cfg,
    n_hospitals, device)`` (flat dicts: the fronts and the middle),
    ``model(cfg)`` (``loss_terms`` of a batch and ``fronts_take_mean``,
    ``reference/train.py``), ``forward_flops(cfg, traffic)`` (one
    sample's forward pass) and ``link_bytes(cfg, traffic, rows)`` (one
    crossing of the cut by ``rows`` samples, as K3 moves it).

The schedule, the SplitFedv3 update, the link, the comparison, the window,
the trace and the readers are shared, and nothing here is specific to one
cell or one family.

A run:
  1. set-up: the hospitals' data and the weights from the seed on the
     card; the program (``build``) holding those weights; the first
     epoch, shuffled by the run's generator, through the window's own
     ``epoch`` (the strategies' ``run_epoch`` captures the window's
     graphs), whose losses, final parameters, Adam moments and validation
     loss the check compares;
  2. the window: whole epochs each followed by ``val_loss``, until
     ``--seconds`` have passed; with ``--trace 1`` the first
     ``TRACED_EPOCHS`` epochs run under the profiler;
  3. the check, once the window has closed, the peak read and the
     program's state freed: the plain reference follows the first epoch
     from the same weights, batches and order, and each number compared
     is printed beside its limit.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack, nullcontext
from pathlib import Path

import numpy as np
import torch

from perfbench import trace
from perfbench.reference import train as R

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACED_EPOCHS = 2
BANNED = ("jax", "jaxlib", "flax", "repro")
CHECKS = ("loss_gap", "epoch_loss_gap", "moment_gap", "update_gap",
          "val_gap")
# the steps whose losses round-off has not yet parted (``loss_gap``): from
# the second update on Adam amplifies it, step by step, until later losses
# part as far in float32 as between float32 and TF32
FIRST_STEPS = 2
# a leaf whose reference gradient norm is under this share of the median
# leaf's moves by round-off alone and is left out of the update's check
NOUGHT = 1e-3


# -- finding a cell's parts by name -----------------------------------------

def bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def cell(name: str, b: dict) -> tuple:
    """(workload entry, config, traffic, limits or None) of cell ``name``."""
    w = next((w for w in b["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in b["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    path = HERE / "limits" / f"{name}.json"
    limits = json.loads(path.read_text()) if path.exists() else None
    return w, cfg, _json("traffic", w["traffic"]), limits


def module(kind: str, name: str):
    """``metrics/<name>.py`` or ``end_to_end/<name>.py`` (names may hold
    dots, so by file, not by import path)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(cfg: dict, part: str):
    """``families/<cfg["family"]>/<part>.py``, ``part`` ``program`` or
    ``reference``."""
    name = cfg["family"]
    if not name.isidentifier() or not (HERE / "families" / name).is_dir():
        raise KeyError(f"no family {name!r} in perfbench/families/")
    return importlib.import_module(f"perfbench.families.{name}.{part}")


def metrics_of(b: dict, workload: str, trace_on: bool) -> list:
    """The cell's metric entries: the per-layer ones with ``--trace 1``,
    the end-to-end ones without; an entry with ``workloads`` counts only
    in those cells."""
    entries = b["per_layer"] if trace_on else b["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


# -- the schedule: what one epoch trains ----------------------------------------

def train_sizes(traffic: dict) -> list:
    """Each hospital's training samples: the traffic's ``train_samples``
    (``train_images`` in the image mixes)."""
    return traffic.get("train_samples", traffic.get("train_images"))


def batches_of(traffic: dict) -> list:
    return [n // traffic["batch"] for n in train_sizes(traffic)]


def epoch_steps(traffic: dict) -> int:
    """Steps a SplitFedv3 epoch takes: every hospital steps at once, as
    many steps as the most batches (the others wrap around)."""
    return max(batches_of(traffic))


def step_samples(traffic: dict) -> int:
    return len(train_sizes(traffic)) * traffic["batch"]


# -- set-up ----------------------------------------------------------------------

def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def set_up(cfg: dict, traffic: dict, seed: int, device,
           precision: str | None = None) -> dict:
    """Everything before the window: inputs, the program with the
    benchmark's weights, and its first epoch with the window's call and
    feed, shuffled by the run's generator (``rng``, which the window goes
    on drawing from).  ``first``: that epoch's losses ([steps, hospitals
    or 1]), the parameters and Adam first moments after it, and the
    validation loss."""
    if traffic["kind"] != "train" or not traffic["method"].startswith(
            "sflv3") or traffic["privacy"] is not None:
        raise ValueError(f"{traffic['method']!r}: this harness trains "
                         "SplitFedv3 without privacy")
    ref, program = family(cfg, "reference"), family(cfg, "program")
    model = ref.model(cfg)
    clients = ref.hospitals(seed, cfg, traffic, device)
    fronts, middle = ref.weights(seed, cfg, len(clients), device)
    strat = program.build(cfg, traffic, device, precision)
    state = program.load(strat, fronts, middle)
    rng = np.random.default_rng(seed)
    state, losses = program.epoch(strat, state, [c.train for c in clients],
                                  rng, traffic["batch"])
    first = {"losses": losses, "params": program.params(state),
             "moments": program.moments(state),
             "val": program.val_loss(strat, state, clients)}
    return {"model": model, "clients": clients, "init": (fronts, middle),
            "seed": seed, "rng": rng, "program": program, "strat": strat,
            "state": state, "first": first}


# -- the check ---------------------------------------------------------------------

def reference(cfg: dict, traffic: dict, s: dict, device, tf32=False,
              link: str | None = None, half=False, frozen=False,
              wrap=True, shuffle=True) -> dict:
    """The plain reference's readings of the first epoch, from the same
    weights, the batches the seed's generator shuffles, in the same order:
    in full float32 (``tf32=True``: the control's TF32), over the
    traffic's link (``link`` overrides it).  Faults: ``half`` averages
    each hospital's loss over half of its rows; ``frozen`` is a step that
    returns its state unchanged (the losses at the initial weights, no
    moment, no change); ``wrap=False``, a hospital short of batches
    repeats its last instead of wrapping around to its first;
    ``shuffle=False``, the epoch in the data's order."""
    model, clients = s["model"], s["clients"]

    def on_device(d, idx=slice(None)):
        return {k: torch.from_numpy(v[idx]).to(device) for k, v in d.items()}
    order = R.epoch_batches(train_sizes(traffic), traffic["batch"],
                            np.random.default_rng(s["seed"]) if shuffle
                            else _Unshuffled())
    if not wrap:
        nb = batches_of(traffic)
        order = [[order[min(i, nb[h] - 1)][h] for h in range(len(nb))]
                 for i in range(len(order))]
    steps = [[(h, on_device(clients[h].train, idx)) for h, idx in step]
             for step in order]
    fronts, middle = s["init"]
    with R.precision(tf32):
        losses, grads, params, moments = R.train_steps(
            model, fronts, middle, steps,
            0.0 if frozen else traffic["optimizer"]["lr"],
            link or traffic["link"]["codec"], half)
        if frozen:
            moments = ([{k: torch.zeros_like(v) for k, v in m.items()}
                        for m in moments[0]],
                       {k: torch.zeros_like(v) for k, v in moments[1].items()})
        val = R.val_loss(model, params[0], params[1],
                         [on_device(c.val) for c in clients])
    return {"losses": losses, "grads": grads, "params": params,
            "moments": moments, "val": val}


class _Unshuffled:
    def shuffle(self, idx) -> None:
        pass


def _leaf_norms(pair) -> dict:
    fronts, middle = pair
    out = {("h", h) + p: float(t.float().norm())
           for h, f in enumerate(fronts) for p, t in f.items()}
    out.update({("m",) + p: float(t.float().norm()) for p, t in middle.items()})
    return out


def _deltas(after, before) -> tuple:
    fa, ma = after
    fb, mb = before
    return ([{p: a[p] - b[p] for p in a} for a, b in zip(fa, fb)],
            {p: ma[p] - mb[p] for p in ma})


def _worst_leaf(prog: dict, ref: dict, keep) -> tuple:
    """The largest gap of a leaf's norm, program against reference, over
    the larger of the reference leaf's norm and the median leaf's; and
    that leaf."""
    med = statistics.median(ref[k] for k in keep)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}
    if not all(map(math.isfinite, gaps.values())):
        return math.inf, None
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def compare(prog: dict, ref: dict, init: tuple, where: bool = False):
    """The numbers a check compares (``CHECKS``) of the first epoch:
    ``loss_gap``, the widest relative gap of a hospital's loss in the
    first ``FIRST_STEPS`` steps, and ``epoch_loss_gap`` in any step;
    ``moment_gap`` and ``update_gap``, by the worst leaf, Adam's first
    moment and the parameters' change after the epoch; ``val_gap``, the
    validation loss's relative gap.  A program that reports one loss a
    step, the mean over hospitals ([steps, 1]), is held to the mean of
    the reference's.  ``where``: also the step and hospital of the widest
    loss gap, the worst leaves, and each step's widest loss gap."""
    # [steps, hospitals], the reference's losses being step-major
    n = len(init[0])
    lr = np.asarray(ref["losses"], np.float64).reshape(-1, n)
    lp = np.asarray(prog["losses"], np.float64).reshape(len(lr), -1)
    if lp.shape[1] == 1 and n > 1:
        lr = lr.mean(axis=1, keepdims=True)
    loss = np.abs(lp - lr) / np.abs(lr)
    gr = _leaf_norms(ref["grads"])
    med = statistics.median(gr.values())
    up = _leaf_norms(_deltas(prog["params"], init))
    ur = _leaf_norms(_deltas(ref["params"], init))
    # a leaf the first step reaches with a nought gradient moves by
    # round-off alone
    moved = [k for k in ur if gr[k] >= NOUGHT * med]
    moment, moment_at = _worst_leaf(_leaf_norms(prog["moments"]),
                                    _leaf_norms(ref["moments"]), list(gr))
    update, update_at = _worst_leaf(up, ur, moved)
    val_gap = abs(prog["val"] - ref["val"]) / abs(ref["val"])
    out = {"loss_gap": float(np.max(loss[:FIRST_STEPS])),
           "epoch_loss_gap": float(np.max(loss)), "moment_gap": moment,
           "update_gap": update, "val_gap": val_gap}
    out = {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}
    if not where:
        return out
    return out, {"loss_at": [int(i) for i in np.unravel_index(
        int(np.nanargmax(loss)), loss.shape)] if np.isfinite(loss).all()
        else None, "moment_at": moment_at, "update_at": update_at,
        "left_out": len(ur) - len(moved),
        "step_loss_gaps": np.max(loss, axis=1).tolist()}


# -- one run ------------------------------------------------------------------------

def card_power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _window(s: dict, traffic: dict, seconds: float, device, traced: bool):
    """Whole epochs until ``seconds`` have passed; returns the window's
    record (with each epoch's seconds and the program's ``pack`` span in
    it) and, traced, the profiled epochs' record."""
    program, strat, clients = s["program"], s["strat"], s["clients"]
    train = [c.train for c in clients]
    n_traced = TRACED_EPOCHS if traced else 0
    # the program's host spans, a few a epoch: cheap, and read in every run
    tracer = program.attach_tracer(strat)
    if traced:
        dt = trace.DeviceTrace()
        profiling = ExitStack()
        profiling.enter_context(dt.profiling())
        d0, p0, tp0 = (program.dispatches(strat), time.perf_counter(),
                       len(tracer.events))
    epochs = attempted = failed = 0
    prof_rec, times, e0 = None, [], len(tracer.events)
    t0 = t_epoch = time.perf_counter()
    while True:
        with trace.span("run_epoch") if traced else nullcontext():
            s["state"], losses = program.epoch(strat, s["state"], train,
                                               s["rng"], traffic["batch"])
        with trace.span("val_loss") if traced else nullcontext():
            program.val_loss(strat, s["state"], clients)
        epochs += 1
        times.append(time.perf_counter() - t_epoch)
        attempted += losses.shape[0]
        failed += int((~np.isfinite(losses)).any(axis=1).sum())
        if epochs == n_traced:
            sync(device)
            wall = time.perf_counter() - p0
            profiling.close()
            prof_rec = {"wall_s": wall, "epochs": epochs,
                        "dispatches": program.dispatches(strat) - d0,
                        "tracer": tracer, "dt": dt,
                        "tracer_events": (tp0, len(tracer.events))}
        t_epoch = time.perf_counter()     # the profiler's stop is no epoch
        if t_epoch - t0 >= seconds and epochs >= n_traced:
            break
    sync(device)
    packs = [e["dur"] / 1e6 for e in tracer.events[e0:] if e["name"] == "pack"]
    return {"window_s": time.perf_counter() - t0, "epochs": epochs,
            "epoch_s": times, "pack_s": packs, "attempted": attempted,
            "failed": failed}, prof_rec


def traced_record(prof: dict, cfg: dict, traffic: dict) -> dict:
    """The record the per-layer readers take (``metrics/*.py``); the
    FLOP and byte counts are the family's reference's."""
    ref = family(cfg, "reference")
    tracer = prof["tracer"]
    epoch0 = time.perf_counter() - tracer.now()
    events = tracer.events[slice(*prof["tracer_events"])]
    host = [(e["name"], epoch0 + e["ts"] / 1e6,
             epoch0 + (e["ts"] + e["dur"]) / 1e6) for e in events]
    rec = prof["dt"].record(host)
    spans: dict = {}
    for e in events:
        spans.setdefault(e["name"], []).append(e["dur"] / 1e6)
    peaks = json.loads((HERE / "peaks.json").read_text())
    steps = prof["epochs"] * epoch_steps(traffic)
    rec.update(
        classes=trace.kernel_classes(), wall_s=prof["wall_s"],
        busy_s=trace.busy_us(rec["kernels"]) / 1e6, epochs=prof["epochs"],
        steps=steps, samples=steps * step_samples(traffic),
        dispatches=prof["dispatches"], program_spans=spans,
        flops_per_sample=ref.forward_flops(cfg, traffic),
        peak_flops_per_s=peaks["flops_per_s"][cfg["precision"]],
        hbm_bytes_per_s=peaks["hbm_bytes_per_s"],
        k3_bytes_per_step=(ref.link_bytes(cfg, traffic, step_samples(traffic))
                           if traffic["link"]["codec"] == "int8"
                           and traffic["link"]["fused"] else 0))
    return rec


def log(msg: str) -> None:
    sys.stderr.write(f"[perfbench] {msg}\n")
    sys.stderr.flush()


def run(workload: str, seed: int, seconds: float, traced: bool,
        t_start: float, device=None, b: dict | None = None,
        parts: tuple | None = None) -> dict:
    """One run of cell ``workload``; the result's dict (``run.py`` prints
    it).  ``device`` None: the first CUDA card.  ``b`` and ``parts``
    (``cell``'s four) stand in for the files: the CPU tests drive a run of
    a small cell through them."""
    b = bench() if b is None else b
    _, cfg, traffic, limits = cell(workload, b) if parts is None else parts
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    power = card_power_limit() if on_card else "cpu"
    s = set_up(cfg, traffic, seed, device)
    sync(device)
    setup_s = time.perf_counter() - t_start

    log(f"set-up {setup_s:.1f} s")
    win, prof = _window(s, traffic, seconds, device, traced)
    log(f"window {win['window_s']:.1f} s, {win['epochs']} epochs of "
        + " ".join(f"{t:.3f}" for t in win["epoch_s"]) + " s; pack "
        + " ".join(f"{t:.3f}" for t in win["pack_s"]) + " s")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    rec = dict(win, setup_s=setup_s, peak_bytes=peak,
               samples=win["attempted"] * step_samples(traffic))
    breakdown, busy = None, None
    if traced:
        trec = traced_record(prof, cfg, traffic)
        values = {m["name"]: module("metrics", m["name"]).read(trec)
                  for m in metrics_of(b, workload, True)}
        lo = trec["start_us"]
        hi = lo + trec["wall_s"] * 1e6
        breakdown = {"device_ops": [[n, t] for n, t in
                                    trace.device_ops(trec["kernels"])],
                     "idle_gaps": [[n, t] for n, t in trace.idle_gaps(
                         trec["kernels"], trec["spans"], lo, hi)[:10]]}
        busy = trec["busy_s"]
        wall = trec["wall_s"]
        log(f"trace read: {len(trec['kernels'])} device events, "
            f"{time.perf_counter() - t_start:.1f} s from the start")
    else:
        values = {m["name"]: module("end_to_end", m["name"]).read(rec)
                  for m in metrics_of(b, workload, False)}
    found = sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))

    prog = s["first"]
    init = s["init"]
    del s["strat"], s["state"], prof
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference(cfg, traffic, s, device)
    got = compare(prog, ref, init)
    log(f"reference {time.perf_counter() - t_ref:.1f} s")
    checks = {k: {"value": got[k],
                  "limit": None if limits is None else limits[k]}
              for k in CHECKS}
    correct = limits is not None and all(
        c["value"] <= c["limit"] for c in checks.values()) and win[
            "failed"] == 0
    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(device) if on_card
                  else "cpu", "count": 1, "memory_peak_bytes": peak,
                  "power": power}
    if traced:
        device_rec.update(busy_s=busy, window_s=wall)
    out = {"correct": bool(correct), "attempted": win["attempted"],
           "failed": win["failed"],
           "metrics": {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in metrics_of(b, workload, traced)
                       if values[m["name"]] is not None},
           "device": device_rec}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    out["_banned_modules"] = found
    return out
