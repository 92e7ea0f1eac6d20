"""Federated learning on the synthetic CXR task and the int8 cut-layer link,
on the PyTorch port (the port's ``examples/federated_cxr.py``: the same
model, data and methods).

Shows the paper's headline trade-off directly: FL moves model-sized bytes
per round; SL-family methods move activation-sized bytes per batch; the
int8 codec (K1/K2 on the card) cuts the SL link bytes about 4x.  It runs
on the CUDA card unless given ``--device cpu``.

  PYTHONPATH=src python examples/federated_cxr_torch.py [--device cpu]
      [--hospitals N] [--images N] [--epochs N]
"""

import argparse

import numpy as np

from repro_torch import optim as O
from repro_torch.core.comm import comm_per_epoch
from repro_torch.core.partition import cnn_adapter
from repro_torch.core.strategies import make_strategy
from repro_torch.data.synthetic import make_cxr_clients
from repro_torch.device import resolve_device
from repro_torch.models.cnn import DenseNetConfig, build_densenet
from repro_torch.wire import make_codec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hospitals", type=int, default=5)
    ap.add_argument("--images", type=int, default=64,
                    help="train images per hospital")
    ap.add_argument("--epochs", type=int, default=4, help="FL rounds")
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    clients = make_cxr_clients(seed=0, n_clients=args.hospitals,
                               train_per_client=args.images,
                               val_per_client=32, test_per_client=32,
                               image_size=32)
    cfg = DenseNetConfig(growth=8, blocks=(2, 4), stem_ch=16, cut_layer=2)
    adapter = cnn_adapter(build_densenet(cfg))
    eb = {k: v[:16] for k, v in clients[0].train.items()}
    n_tr = [len(c.train["label"]) for c in clients]
    n_va = [len(c.val["label"]) for c in clients]

    print("per-epoch communication (analytic, paper Table 4 analogue):")
    profiles = {}
    for method in ["fl", "sl_ac", "sflv3_ac"]:
        c = profiles[method] = comm_per_epoch(method, adapter, eb, n_tr,
                                              n_va, 16)
        print(f"  {method:10s} {c.gb * 1e3:8.2f} MB   {c.breakdown}")
    raw = profiles["sl_ac"]
    c8 = profiles["sl_ac+int8"] = comm_per_epoch(
        "sl_ac", adapter, eb, n_tr, n_va, 16, codec=make_codec("int8"))
    print(f"  sl_ac+int8 {c8.gb * 1e3:8.2f} MB   "
          f"(cut-layer tensors int8+row-scale via repro_torch.wire, "
          f"{raw.bytes_per_epoch / c8.bytes_per_epoch:.2f}x)")

    print(f"\ntraining FL for {args.epochs} rounds on {device}:")
    strat = make_strategy("fl", adapter, lambda: O.adam(3e-4), len(clients),
                          device=device)
    state = strat.setup(0)
    rng = np.random.default_rng(0)
    losses, val = [], []
    for r in range(args.epochs):
        state, log = strat.run_epoch(state, [c.train for c in clients],
                                     rng, 16)
        m = strat.evaluate(state, clients, "val", 32)
        losses.append(log.mean_loss)
        val.append(m["auroc"])
        print(f"  round {r}: loss={log.mean_loss:.4f} "
              f"val_auroc={m['auroc']:.3f}")
    test = strat.evaluate(state, clients, "test", 32)
    print("test:", test)
    return {"bytes": {k: c.bytes_per_epoch for k, c in profiles.items()},
            "losses": losses, "val_auroc": val, "test": test}


if __name__ == "__main__":
    main()
