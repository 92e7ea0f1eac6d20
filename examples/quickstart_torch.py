"""Quickstart on the PyTorch port (the port's ``examples/quickstart.py``: the
same model, data and methods): train SplitFedv3 (the paper's method)
across five virtual hospitals on the synthetic chest-X-ray task, compare
with plain split learning, then serve hospital 0's export.  It runs on the
CUDA card unless given ``--device cpu``.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
      [--hospitals N] [--images N] [--epochs N]
"""

import argparse
import time

import numpy as np

from repro_torch import optim as O
from repro_torch.core.partition import cnn_adapter
from repro_torch.core.strategies import make_strategy
from repro_torch.data.synthetic import make_cxr_clients
from repro_torch.device import resolve_device
from repro_torch.models.cnn import DenseNetConfig, build_densenet
from repro_torch.obs import Telemetry
from repro_torch.serving import ScreeningService


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hospitals", type=int, default=5)
    ap.add_argument("--images", type=int, default=64,
                    help="train images per hospital")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # non-IID scanners (see repro_torch/data/synthetic.py)
    clients = make_cxr_clients(seed=0, n_clients=args.hospitals,
                               train_per_client=args.images,
                               val_per_client=32, test_per_client=32,
                               image_size=32)
    cfg = DenseNetConfig(growth=8, blocks=(2, 4), stem_ch=16, cut_layer=2)

    results = {}
    for method in ["sflv3_ac", "sl_ac"]:
        adapter = cnn_adapter(build_densenet(cfg))
        # the default compiled engine steps the whole run with captured
        # CUDA graphs (engine="stepwise" is the per-batch host loop; both
        # train identically).  observe= taps per-round telemetry inside
        # those graphs; params stay bit-identical.
        strat = make_strategy(method, adapter, lambda: O.adam(3e-4),
                              n_clients=len(clients), observe=Telemetry(),
                              device=device)
        state = strat.setup(0)
        rng = np.random.default_rng(0)
        t0 = time.time()
        state, logs = strat.run(state, [c.train for c in clients], rng,
                                batch_size=16, n_epochs=args.epochs)
        for epoch, log in enumerate(logs):
            print(f"[{method}] epoch {epoch}: loss={log.mean_loss:.4f}")
        print(f"[{method}] per-round telemetry (hospital means; see "
              "repro_torch.obs):")
        print(strat.last_run_telemetry.table())
        metrics = strat.evaluate(state, clients, "test", batch_size=32)
        print(f"[{method}] test {metrics}  ({time.time() - t0:.0f}s)\n")
        results[method] = {"losses": [l.mean_loss for l in logs],
                           "test": metrics}

    # serve the result: hospital 0's deployable model (its own front and
    # the shared server, stitched at the cut) behind a batched screening
    # service, one captured graph a bucket, so steady-state requests never
    # capture anew
    servable = strat.export(state, client_idx=0)
    image = clients[0].test["image"][0]
    with ScreeningService(servable, image_shape=image.shape,
                          max_wait_s=0.002) as svc:
        score = svc.score_one({"image": image})
        p50 = svc.stats()["total_p50_ms"]
        print(f"[serve] {servable.family} export v{svc.version} on "
              f"{device}: first test image scores {score:.4f} "
              f"(p50 {p50:.2f} ms)")
    results["serve"] = {"score": score, "p50_ms": p50}
    return results


if __name__ == "__main__":
    main()
