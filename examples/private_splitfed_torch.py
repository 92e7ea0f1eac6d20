"""SplitFedv3 under differential privacy on the PyTorch port (the port's
``examples/private_splitfed.py``: the same model, data, regimes and
flags).

Trains the paper's proposed SFLv3 on the synthetic 5-hospital CXR task
three ways:

  * non-private (the paper's regime),
  * DP-SGD: per-example clip and Gaussian noise (K5/K6 on the card), with
    the RDP accountant reporting per-hospital (eps, delta),
  * cut-layer noise: Gaussian noise on the smashed activations only (Li
    et al.'s mitigation; no gradient accounting, but it directly attacks
    the No-Peek server-inference channel),

and reports AUROC beside what an honest-but-curious server can still
extract from the cut layer: distance correlation with the raw inputs and
a linear reconstruction probe's held-out R^2, measured on exactly what
crosses the wire.  It runs on the CUDA card unless given ``--device
cpu``.

  PYTHONPATH=src python examples/private_splitfed_torch.py [--epochs N]
      [--sigma S] [--clip C] [--cut-noise STD] [--device cpu]
      [--hospitals N] [--images N]
"""

import argparse
import math

import numpy as np
import torch

from repro_torch import optim as O
from repro_torch.core.partition import cnn_adapter
from repro_torch.core.strategies import make_strategy
from repro_torch.data.synthetic import make_cxr_clients
from repro_torch.device import resolve_device
from repro_torch.models.cnn import DenseNetConfig, build_densenet
from repro_torch.privacy import PrivacyConfig, measure_leakage

# train images per hospital: unequal data, so unequal epsilon
IMAGES = [96, 192, 48, 96, 48]


def train(adapter, clients, epochs, privacy, device, batch_size=16, seed=0):
    strat = make_strategy("sflv3_ac", adapter, lambda: O.adam(3e-4),
                          len(clients), privacy=privacy, device=device)
    state = strat.setup(seed)
    rng = np.random.default_rng(seed)
    logs = []
    for _ in range(epochs):
        state, log = strat.run_epoch(state, [c.train for c in clients],
                                     rng, batch_size)
        logs.append(log)
    metrics = strat.evaluate(state, clients, "test", 32)
    return strat, state, metrics, logs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--cut-noise", type=float, default=0.5)
    ap.add_argument("--hospitals", type=int, default=len(IMAGES))
    ap.add_argument("--images", type=int, nargs="+", default=IMAGES,
                    help="train images of each hospital (one number: all)")
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    images = (args.images * args.hospitals if len(args.images) == 1
              else args.images[:args.hospitals])
    clients = make_cxr_clients(seed=0, n_clients=args.hospitals,
                               train_per_client=images,
                               val_per_client=32, test_per_client=48,
                               image_size=32)
    cfg = DenseNetConfig(growth=8, blocks=(2, 4), stem_ch=16, cut_layer=2)
    adapter = cnn_adapter(build_densenet(cfg))

    regimes = [
        ("non-private", None),
        (f"dp-sgd s={args.sigma:g} C={args.clip:g}",
         PrivacyConfig(noise_multiplier=args.sigma, clip_norm=args.clip)),
        (f"cut-noise std={args.cut_noise:g}",
         PrivacyConfig(cut_noise_std=args.cut_noise)),
    ]

    print(f"sflv3_ac on {len(clients)} synthetic hospitals, {args.epochs} "
          f"epochs, on {device}\n")
    dp_strat, out = None, {}
    for label, privacy in regimes:
        strat, state, m, logs = train(adapter, clients, args.epochs,
                                      privacy, device)
        if privacy is not None and privacy.dp_enabled:
            dp_strat = strat
        params = strat.params_for_eval(state, 0)
        probe_batch = {k: torch.from_numpy(v[:64]).to(device)
                       for k, v in clients[0].test.items()}
        leak = measure_leakage(adapter, params, probe_batch,
                               privacy=privacy)
        report = strat.privacy_report()
        if report:
            eps = max(r["epsilon"] for r in report)
            eps_s = ("inf" if math.isinf(eps)
                     else f"{eps:.2f} (delta={report[0]['delta']:g})")
        else:
            eps_s = "-"
        print(f"  {label:24s} loss={logs[-1].mean_loss:.4f} "
              f"auroc={m['auroc']:.3f} sens={m['sensitivity']:.2f} "
              f"spec={m['specificity']:.2f}")
        print(f"  {'':24s} eps={eps_s}  "
              f"cut-layer dCor={leak['dcor_input']:.3f} "
              f"probe R2={leak['probe']['r2']:.3f}\n")
        out[label] = {"losses": [l.mean_loss for l in logs], "test": m,
                      "dcor": leak["dcor_input"],
                      "probe_r2": leak["probe"]["r2"], "privacy": report}

    if dp_strat is not None:
        print("per-hospital accountants (unequal data => unequal eps):")
        for i, r in enumerate(dp_strat.privacy_report()):
            print(f"  DT{i + 1}: eps={r['epsilon']:.2f} "
                  f"steps={r['steps']}")
    out["train_images"] = images
    return out


if __name__ == "__main__":
    main()
