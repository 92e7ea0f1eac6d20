"""Observed training on the PyTorch port: every distributed strategy of the
paper's grid run with full telemetry, merged into ONE Chrome-trace/Perfetto
JSON (the port's ``examples/observed_splitfed.py``: the same flags and the
same three outputs).

Each of the five distributed strategies (FL, SL alternate-minibatch,
SFLv1/v2/v3) trains the synthetic multi-hospital CXR task on the compiled
engine with ``observe=Telemetry()``: per-round x per-hospital train loss,
grad/update norms, the FedAvg update cosine, cut-layer activation stats,
DP clip fractions and the per-round RDP epsilon series are computed inside
the captured CUDA graphs and read back once with the losses (params
bit-equal to an unobserved run; tests/test_torch_obs.py).  Around the
replays, a ``Tracer`` records the host phases (run -> pack -> dispatch),
and the wire simulator replays each method's transfers over the hospital
WAN into per-client timelines.

All three views land in one ``trace_observed.json`` — engine-host lanes
(with synthetic per-round slices carrying the telemetry and epsilon
counter tracks), one simulated-wire lane per strategy — loadable in
chrome://tracing or https://ui.perfetto.dev.  Per strategy it also writes
``RUNLOG_<method>.json`` (telemetry + cost summary: replays, capture
seconds, kernel launches per replay, step FLOPs, peak memory) and a
markdown report.  It runs on the CUDA card unless given ``--device cpu``.

  PYTHONPATH=src python examples/observed_splitfed_torch.py [--smoke]
      [--out OUT_DIR] [--epochs N] [--batch B] [--no-dp] [--device cpu]
"""

import argparse
import json
import os
import time

import numpy as np

from repro_torch import optim as O
from repro_torch.core.partition import cnn_adapter
from repro_torch.core.strategies import make_strategy
from repro_torch.data.synthetic import make_cxr_clients
from repro_torch.device import resolve_device
from repro_torch.models.cnn import DenseNetConfig, build_densenet
from repro_torch.obs import (Telemetry, Tracer, cost_summary, merge_events,
                             round_events, wire_events, write_chrome_trace,
                             write_report, write_runlog)
from repro_torch.privacy import PrivacyConfig
from repro_torch.wire import Transport
from repro_torch.wire.simulator import simulate, timeline_from_accounting

METHODS = ["fl", "sl_am", "sflv1_ac", "sflv2_ac", "sflv3_ac"]


def observe_one(method, adapter, clients, batch, epochs, privacy, device):
    """Train one strategy observed; return (telemetry, trace events, cost
    summary)."""
    transport = (Transport("identity", device=device) if method != "fl"
                 else None)
    strat = make_strategy(method, adapter, lambda: O.adam(1e-3),
                          len(clients), transport=transport,
                          privacy=privacy, observe=Telemetry(),
                          device=device)
    tracer = strat.attach_tracer(Tracer())
    state = strat.setup(0)
    data = [c.train for c in clients]
    t0 = time.perf_counter()
    state, logs = strat.run(state, data, np.random.default_rng(0), batch,
                            epochs)
    wall = time.perf_counter() - t0
    rt = strat.last_run_telemetry

    # engine-host lane: real spans + synthetic per-round slices of the
    # dispatch span, carrying telemetry args and epsilon counters
    events = tracer.trace_events()
    events += round_events(rt, tracer.find("dispatch"))

    # wire lane: simulated per-client transfer timelines.  Cut-layer
    # methods replay the transport's recorded accounting; FL (no cut
    # traffic) models its round legs analytically.
    n_va = [len(c.val["label"]) for c in clients]
    if transport is not None:
        sim = timeline_from_accounting(transport, n_val=n_va,
                                       batch_size=batch)
    else:
        eb = {k: v[:1] for k, v in clients[0].train.items()}
        sim = simulate("fl", adapter, eb,
                       [len(c.train["label"]) for c in clients], n_va,
                       batch)
    events += wire_events(sim, label=method)

    steps = sum(l.steps for l in logs)
    cost = cost_summary(strat, wall_seconds=wall, total_steps=steps)
    cost["wire"] = {"bytes_on_wire": sim.bytes_on_wire,
                    "sim_wall_clock_s": sim.wall_clock_s}
    return rt, events, cost


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes (seconds, not minutes)")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "out"))
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--no-dp", action="store_true",
                    help="train without DP-SGD (drops the epsilon "
                         "counter tracks)")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain PyTorch path on the CPU "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.smoke:
        clients = make_cxr_clients(seed=0, train_per_client=[17, 12, 9],
                                   val_per_client=6, test_per_client=7,
                                   image_size=16, n_clients=3)
        cfg = DenseNetConfig(growth=4, blocks=(1, 1), stem_ch=8,
                             cut_layer=1)
        batch, epochs = args.batch or 4, args.epochs or 2
    else:
        clients = make_cxr_clients(seed=0, train_per_client=64,
                                   val_per_client=16, test_per_client=16,
                                   image_size=32)
        cfg = DenseNetConfig(growth=8, blocks=(2, 2), stem_ch=16,
                             cut_layer=2)
        batch, epochs = args.batch or 16, args.epochs or 3
    adapter = cnn_adapter(build_densenet(cfg))
    privacy = (None if args.no_dp
               else PrivacyConfig(noise_multiplier=1.1, clip_norm=1.0))

    os.makedirs(args.out, exist_ok=True)
    merged = []
    for i, method in enumerate(METHODS):
        rt, events, cost = observe_one(method, adapter, clients, batch,
                                       epochs, privacy, device)
        # each strategy gets its own pid block so all five coexist in one
        # trace file
        merged += merge_events(events, pid_offset=10 * i)
        write_runlog(args.out, method, telemetry=rt, cost=cost)
        write_report(args.out, method, rt, cost=cost)
        last = rt.rounds[-1].scalars()
        print(f"[{method}] {epochs} rounds, {cost['dispatches']} replays in "
              f"{cost['run_calls']} run, "
              f"loss={last.get('loss', float('nan')):.4f}"
              + (f", eps_max={last['epsilon_max']:.2f}"
                 if "epsilon_max" in last else ""))
        print(rt.table())
        print()

    path = write_chrome_trace(merged,
                              os.path.join(args.out,
                                           "trace_observed.json"))
    with open(path) as f:
        n_events = len(json.load(f)["traceEvents"])
    print(f"wrote {path} ({n_events} events, {len(METHODS)} strategies)")
    print(f"runlogs + reports in {args.out}/")


if __name__ == "__main__":
    main()
