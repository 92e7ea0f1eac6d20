"""SplitFedv3 with a compressed cut-layer link on the PyTorch port (the
port's ``examples/compressed_splitfed.py``: the same model, data, methods
and flags).

Trains the paper's proposed SFLv3 on the synthetic 5-hospital CXR task
twice, once over an uncompressed link and once with the int8 codec
roundtripping every cut-layer tensor (K1 then K2 on the card), and
reports AUROC beside the achieved on-wire compression ratio, plus the
simulated epoch wall-clock over the hospital WAN for each codec.  It runs
on the CUDA card unless given ``--device cpu``.

  PYTHONPATH=src python examples/compressed_splitfed_torch.py
      [--epochs N] [--method M] [--device cpu] [--hospitals N]
      [--images N]
"""

import argparse

import numpy as np
import torch

from repro_torch import optim as O
from repro_torch.core.partition import cnn_adapter
from repro_torch.core.strategies import make_strategy
from repro_torch.data.synthetic import make_cxr_clients
from repro_torch.device import resolve_device
from repro_torch.models.cnn import DenseNetConfig, build_densenet
from repro_torch.wire import Transport, boundary_error, simulate


def train(method, adapter, clients, epochs, device, codec=None, seed=0):
    transport = Transport(codec, device=device) if codec else None
    strat = make_strategy(method, adapter, lambda: O.adam(3e-4),
                          len(clients), transport=transport, device=device)
    state = strat.setup(seed)
    rng = np.random.default_rng(seed)
    logs = []
    for _ in range(epochs):
        state, log = strat.run_epoch(state, [c.train for c in clients],
                                     rng, 16)
        logs.append(log)
    metrics = strat.evaluate(state, clients, "test", 32)
    return state, strat, metrics, logs, transport


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--method", default="sflv3_ac")
    ap.add_argument("--hospitals", type=int, default=5)
    ap.add_argument("--images", type=int, default=96,
                    help="train images per hospital")
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    clients = make_cxr_clients(seed=0, n_clients=args.hospitals,
                               train_per_client=args.images,
                               val_per_client=32, test_per_client=48,
                               image_size=32)
    cfg = DenseNetConfig(growth=8, blocks=(2, 4), stem_ch=16, cut_layer=2)
    adapter = cnn_adapter(build_densenet(cfg))

    print(f"{args.method} on {len(clients)} synthetic hospitals, "
          f"{args.epochs} epochs, on {device}\n")
    rows, out = [], {"runs": {}}
    for codec in (None, "int8"):
        label = codec or "identity"
        state, strat, m, logs, tp = train(args.method, adapter, clients,
                                          args.epochs, device, codec)
        ratio = tp.compression_ratio if tp else 1.0
        wire_mb = tp.bytes_on_wire / 1e6 if tp else float("nan")
        rows.append((label, m["auroc"], m["auprc"], ratio))
        print(f"  codec={label:8s} loss={logs[-1].mean_loss:.4f} "
              f"test_auroc={m['auroc']:.3f} test_auprc={m['auprc']:.3f} "
              f"compression={ratio:.2f}x"
              + (f" wire={wire_mb:.1f} MB" if tp else ""))
        run = {"losses": [l.mean_loss for l in logs], "test": m,
               "compression": ratio}
        if tp:
            params = strat.params_for_eval(state, 0)
            batch = {k: torch.from_numpy(v[:16]).to(device)
                     for k, v in clients[0].train.items()}
            errs = boundary_error(tp, adapter, params, batch)
            rel = [e["rel_l2"] for v in errs.values() for e in v]
            print(f"           cut-layer rel-L2 reconstruction error: "
                  f"{max(rel):.4f}")
            run.update(bytes_on_wire=tp.bytes_on_wire, rel_l2=max(rel))
        out["runs"][label] = run

    base, comp = rows[0], rows[1]
    print(f"\n  AUROC delta (int8 - identity): {comp[1] - base[1]:+.4f} "
          f"at {comp[3]:.2f}x fewer bytes on the wire")

    eb = {k: v[:16] for k, v in clients[0].train.items()}
    n_tr = [len(c.train["label"]) for c in clients]
    n_va = [len(c.val["label"]) for c in clients]
    print("\nsimulated epoch wall-clock over hospital_wan:")
    out["simulated"] = {}
    for codec in ("identity", "bf16", "int8", "topk:0.1"):
        r = simulate(args.method, adapter, eb, n_tr, n_va, 16, codec,
                     "hospital_wan", keep_events=False)
        out["simulated"][codec] = {"bytes_on_wire": r.bytes_on_wire,
                                   "wall_clock_s": r.wall_clock_s}
        print(f"  {codec:9s} {r.bytes_on_wire / 1e6:8.2f} MB  "
              f"{r.wall_clock_s:6.2f} s")
    return out


if __name__ == "__main__":
    main()
