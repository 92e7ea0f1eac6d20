"""Run one cell of the port's benchmark and print its result as the last
line of standard output.

    python3 perfbench/run.py --workload densenet121.sflv3.fp32 --seed 1 \\
        --seconds 10 --trace 0

Run from the root of a checkout; the cells are ``BENCHMARK.json``'s
``workloads``.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a device trace.  The numbers the
correctness check compares are the last lines of standard error and the
last key of the result.  Exits non-zero, printing no result, without
enough CUDA cards, without the program beside the benchmark, or if JAX or
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    # the program builds its kernels inside the checkout
    # (src/repro_torch/kernels/build/); the CUDA driver's cache goes there too
    os.environ.setdefault("CUDA_CACHE_PATH",
                          str(ROOT / "perfbench" / "out" / "cuda_cache"))
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not beside the benchmark",
              file=sys.stderr)
        return 2

    import torch

    from perfbench import harness

    w = next((w for w in harness.bench(ROOT)["workloads"]
              if w["name"] == a.workload), None)
    if w is None:
        print(f"no workload {a.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"{a.workload} needs {w['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    out = harness.run(a.workload, a.seed, a.seconds, bool(a.trace), T_START)
    found = out.pop("_banned_modules")
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    sys.stderr.write(f"card: {out['device']['power']}\n")
    for name, c in out["checks"].items():
        sys.stderr.write(f"check {name} {c['value']!r} limit {c['limit']!r}\n")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
