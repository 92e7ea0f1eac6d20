"""The readings the correctness limits are set from, on the card at a
cell's own size, many seeds in one process (the benchmark's own runs do
not run this):

  * ``program``: the port against the float32 reference (sound runs; the
    lower reading of each number);
  * ``tf32``: the control, the reference in TF32 put in the program's place
    (the nearest precision below the configuration's float32 with TF32 off);
  * ``bf16``: the program's own bf16 path (``precision="bf16"``);
  * ``half``: a fault, each hospital's loss over half of its rows;
  * ``no_link``: a fault, the int8 cut-layer roundtrip left out;
  * ``frozen``: a fault, a step that returns its state unchanged (reads 1
    on ``moment_gap`` and ``update_gap`` by construction);
  * ``no_wrap``: a fault, a hospital short of batches repeats its last one
    instead of wrapping around;
  * ``unshuffled``: a fault, the epoch in the data's order.

Each reading is of the first epoch, as a run's check reads it.

    python3 perfbench/control.py --workload densenet121.sflv3.fp32 \\
        --seeds 101 102 103 [--variants program tf32 half no_link bf16]

Prints one JSON line per seed and variant, then the largest reading of
``program`` and the smallest of every other variant for each number.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = ("program", "tf32", "half", "no_link", "frozen", "no_wrap",
            "unshuffled", "bf16")


def readings(parts: tuple, seed: int, variants, device) -> dict:
    """The first epoch's readings of each of ``variants`` at ``seed``, on a
    cell's ``parts`` (``harness.cell``'s four), each against the float32
    reference; the family's program and reference come by the
    configuration's ``family``."""
    import torch

    from perfbench import harness

    _, cfg, traffic, _ = parts
    out = {}
    s = harness.set_up(cfg, traffic, seed, device)
    prog = s["first"]
    del s["strat"], s["state"]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = harness.reference(cfg, traffic, s, device)
    ref_s = time.perf_counter() - t
    if "program" in variants:
        out["program"], out["program.where"] = harness.compare(
            prog, ref, s["init"], where=True)
        out["program.where"]["reference_s"] = ref_s
    kw = {"tf32": dict(tf32=True), "half": dict(half=True),
          "no_link": dict(link="identity"), "frozen": dict(frozen=True),
          "no_wrap": dict(wrap=False), "unshuffled": dict(shuffle=False)}
    for v in variants:
        if v in kw:
            out[v], out[v + ".where"] = harness.compare(
                harness.reference(cfg, traffic, s, device, **kw[v]), ref,
                s["init"], where=True)
    if "bf16" in variants:
        b = harness.set_up(cfg, traffic, seed, device, precision="bf16")
        out["bf16"], out["bf16.where"] = harness.compare(
            b["first"], ref, s["init"], where=True)
        del b
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS[:5]),
                    choices=VARIANTS)
    a = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench import harness

    dev = torch.device("cuda", 0)
    print(harness.card_power_limit(), flush=True)
    parts = harness.cell(a.workload, harness.bench())
    allr: dict = {}
    for seed in a.seeds:
        r = readings(parts, seed, a.variants, dev)
        for v, g in r.items():
            print(json.dumps({"seed": seed, "variant": v, **g},
                             default=str), flush=True)
            allr.setdefault(v, []).append(g)
    summary = {}
    for v, rows in allr.items():
        if v.endswith(".where"):
            continue
        pick = max if v == "program" else min
        summary[v] = {k: pick(r[k] for r in rows) for k in harness.CHECKS}
    print(json.dumps({"summary": summary, "seeds": len(a.seeds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
