"""The dry run (``repro_torch.launch.dryrun`` and ``launch.cost_analysis``)
against the reference's (``repro.launch.dryrun`` and ``hlo_analysis``), on
the CPU, nothing allocated.

The port's dry runs go in a fresh process (each builds and destroys a fake
process group; a test process keeps none): SmolLM-135M's SMOKE config
(``train_4k`` and ``decode_32k`` at their full input shapes) on a (1, 1)
and a (2, 2) mesh, and the full SmolLM-135M ``train_4k`` on the single
production mesh through the command line.  Each record has ``status ==
"ok"``, no op result that holds memory (``allocated_results``: on an
accelerator, or on the CPU from a ``meta`` input), and no process group
left.  On one device the per-device FLOPs of each step equal the
reference's ``hlo_analysis.analyze`` of the same step compiled by XLA on
one device within 1e-4 relative: both count 2·m·n·k of every matrix
product of the step (forward, backward and the remat recompute; the
loss's logits included), and the two packages' steps take the same
products (they are equal here; 1e-4 leaves room for an MoE config's
rounding of its dispatch chunks).  One device issues no collective; the
(2, 2) mesh issues all-gathers, reduce-scatters or all-reduces, and each
device there takes fewer FLOPs than the one device does.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest

from repro.configs.registry import REGISTRY as J_REGISTRY
from repro.launch import dryrun as JD
from repro.launch.hlo_analysis import analyze
from repro_torch.launch.dryrun import HW_TABLE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "smollm-135m"
FLOP_BAR = 1e-4
RUNS = [("train_4k", (1, 1)), ("train_4k", (2, 2)), ("decode_32k", (1, 1)),
        ("decode_32k", (2, 2))]

_SCRIPT = """
import dataclasses, json, sys
import torch.distributed as dist
from repro_torch.configs import registry as R
from repro_torch.launch import dryrun as D
e = R.REGISTRY[{arch!r}]
D.REGISTRY[{arch!r}] = dataclasses.replace(e, config=e.smoke)
for shape, mesh in {runs!r}:
    rec = D.run_combo({arch!r}, shape, False, mesh_shape=mesh)
    rec["group_left"] = dist.is_initialized()
    print("REC " + json.dumps(rec), flush=True)
"""


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    env = {**os.environ, "PYTHONPATH": "src"}
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(arch=ARCH, runs=RUNS)],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    recs = [json.loads(l[4:]) for l in out.stdout.splitlines()
            if l.startswith("REC ")]
    assert len(recs) == len(RUNS), out.stderr[-3000:]
    return {(r["shape"], tuple(r["mesh_shape"])): r for r in recs}


def _reference_flops(shape):
    """The reference's per-device FLOPs of the SMOKE step on one device."""
    e = dataclasses.replace(J_REGISTRY[ARCH], config=J_REGISTRY[ARCH].smoke)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    build = {"train": JD.build_train, "prefill": JD.build_prefill,
             "decode": JD.build_decode}[JD.INPUT_SHAPES[shape]["kind"]]
    step, args, in_sh, out_sh = build(e, shape, mesh)
    with mesh:
        txt = jax.jit(step, in_shardings=in_sh,
                      out_shardings=out_sh).lower(*args).compile().as_text()
    return analyze(txt)["flops"]


@pytest.mark.parametrize("shape, mesh", RUNS)
def test_dry_run_is_ok_and_allocates_nothing(port_runs, shape, mesh):
    rec = port_runs[(shape, mesh)]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["allocated_results"] == 0 and not rec["group_left"]
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert rec["param_bytes"] > 0 and rec["peak_live_bytes"] > 0
    coll = sum(v for k, v in rec["collectives"].items() if k != "counts")
    if mesh == (1, 1):
        assert coll == 0 and not any(rec["collectives"]["counts"].values())
    else:
        assert coll > 0
        assert rec["hlo_flops"] < port_runs[(shape, (1, 1))]["hlo_flops"]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_flops_match_the_reference(port_runs, shape):
    mine = port_runs[(shape, (1, 1))]["hlo_flops"]
    ref = _reference_flops(shape)
    assert abs(mine - ref) <= FLOP_BAR * ref, (mine, ref)


def test_command_line_writes_a_full_record(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on the full SmolLM-135M
    ``train_4k``, single production mesh: a record with the H100
    roofline terms."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", "train_4k", "--mesh", "single", "--out",
         str(tmp_path)], capture_output=True, text=True, timeout=600,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": "src"})
    path = tmp_path / f"dryrun_{ARCH}_train_4k_single.json"
    assert path.exists(), out.stdout[-2000:] + out.stderr[-2000:]
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["mesh_shape"] == [16, 16]
    assert rec["allocated_results"] == 0 and rec["hw"] == "h100_sxm"
    roof = rec["roofline"]
    assert roof["t_compute"] == rec["hlo_flops"] / HW_TABLE["h100_sxm"][
        "peak_flops"]
    assert roof["t_memory"] > 0 and roof["t_collective"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
