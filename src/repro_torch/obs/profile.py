"""Profiling — device traces, captured-graph costs and dispatch counts per
strategy (the roles of ``repro/obs/profile.py``, not its code: the port has
no HLO, its programs are captured CUDA graphs).

  * ``torch_profile(dir)`` (for ``jax_profile``): a ``torch.profiler``
    context recording CPU and, on the card, CUDA activity, written as one
    Chrome trace.  It never passes silently: a profiler that cannot start
    raises, and on the card so does a trace that holds no device activity.
  * ``graph_cost(strategy)`` (for ``hlo_cost``): the programs of the
    strategy's last compiled run — captures per body, capture seconds
    (warm-up plus capture), replays in the run, hand-kernel launches per
    replay (``Program.per_replay``), FLOPs of one step
    (``core.flops.segment_fwd_flops`` x 3 x the hospitals a step trains)
    and the peak memory; None before a compiled run.
  * dispatch counts: ``Strategy._dispatches`` tallies host->device
    training-program invocations.  In the reference a compiled run is ONE
    dispatch (one XLA program); in the port it is one graph replay per
    step plus one per begin and round body, and a stepwise step counts
    one.  An observed run replays exactly as many graphs as an unobserved
    one.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def torch_profile(trace_dir):
    """Wrap a block in ``torch.profiler`` tracing; on exit the trace is
    written to ``trace_dir/torch_trace.json`` (chrome://tracing,
    Perfetto), its path on the yielded profiler as ``trace_path``.  With
    a CUDA device the CUDA activity is recorded too, and a trace without
    any raises (the profiler could not see the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(str(trace_dir), exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.trace_path = os.path.join(str(trace_dir), "torch_trace.json")
    prof.start()
    try:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    finally:
        prof.stop()
    prof.export_chrome_trace(prof.trace_path)
    if cuda and not any(getattr(e, "device_type", None) == DeviceType.CUDA
                        for e in prof.events()):
        raise RuntimeError("torch_profile: the trace holds no CUDA activity "
                           "(the profiler could not trace the card)")


def graph_cost(strategy) -> dict | None:
    """The captured programs of the strategy's last compiled run; None
    when it has run none (a new strategy, the stepwise engine)."""
    run = getattr(strategy, "_last_run", None)
    if run is None:
        return None
    from repro_torch.core import flops as F

    prog = run["program"]
    example = {k: v[0] for k, v in prog.batches.items()}
    fwd = F.segment_fwd_flops(strategy.adapter, example)
    return {"program": type(prog).__name__,
            "captures": {b: int(b in prog.graphs) for b in prog.bodies},
            "capture_seconds": dict(prog.capture_s),
            "replays": dict(run["replays"]),
            "launches_per_replay": prog.per_replay,
            "step_flops": F.TRAIN_FACTOR * sum(fwd.values())
            * run["per_step"],
            "peak_bytes": run["peak_bytes"]}


def cost_summary(strategy, wall_seconds: float | None = None,
                 total_steps: int | None = None) -> dict:
    """Per-strategy cost row (the reference's keys): dispatch count, run
    calls, the last run's ``graph_cost`` under ``"graph"`` (the
    reference's ``"hlo"``), and steps/s when the caller timed the run."""
    out = {"strategy": strategy.name, "engine": strategy.engine,
           "dispatches": getattr(strategy, "_dispatches", 0),
           "run_calls": getattr(strategy, "_run_calls", 0)}
    graph = graph_cost(strategy)
    if graph is not None:
        out["graph"] = graph
    if wall_seconds is not None:
        out["wall_seconds"] = wall_seconds
        if total_steps:
            out["steps_per_s"] = total_steps / max(wall_seconds, 1e-9)
    return out


__all__ = ["torch_profile", "graph_cost", "cost_summary"]
