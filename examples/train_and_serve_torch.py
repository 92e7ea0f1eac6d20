"""Close the train->deploy loop on the PyTorch port (the port's
``examples/train_and_serve.py``: the same model, data and methods): a live
screening service absorbing each federated round's model via hot-swap.

A ``ScreeningService`` starts serving after round 1 and keeps answering
single-image requests while FL training continues; after every round the
fresh ``Strategy.export`` is swapped in behind the in-flight-safe
``ModelSlot``.  At each round the script scores the pooled test set BOTH
ways, training-side ``Strategy.scores_all`` and request by request through
the live service, and asserts every served score within 1e-5 of its
training-side score: the service serves the model training just produced,
never a stale or torn one.  (The reference asserts bit-equal AUROCs; the
port's buckets are captured CUDA graphs over cuDNN convolutions chosen by
batch size, so a bucket agrees with ``scores_all`` within 1e-5 in f32, as
``serving/scorer.py`` states.)  It prints both AUROCs and the largest
difference.

The coda round-trips a SplitFedv3 export (hospital 2's front stitched
with the shared server at the cut) through the on-disk checkpoint format,
bit-exactly, and re-serves it: the multi-hospital strategies deploy
through the same path as FL.  It runs on the CUDA card unless given
``--device cpu``.

  PYTHONPATH=src python examples/train_and_serve_torch.py [--device cpu]
      [--hospitals N] [--images N] [--epochs N]
"""

import argparse
import concurrent.futures as cf
import os
import tempfile

import numpy as np
import torch

from repro_torch import optim as O
from repro_torch.core.partition import cnn_adapter
from repro_torch.core.strategies import make_strategy
from repro_torch.data.synthetic import make_cxr_clients
from repro_torch.device import resolve_device
from repro_torch.models.cnn import DenseNetConfig, build_densenet
from repro_torch.serving import ScreeningService, load_servable, save_servable
from repro_torch.train.metrics import auroc
from repro_torch.tree import tree_leaves

SERVE_BAR = 1e-5        # served against training-side scores, f32


def pooled_test(clients):
    return (np.concatenate([c.test["image"] for c in clients]),
            np.concatenate([c.test["label"] for c in clients]))


def serve_scores(svc, images):
    """Score the pooled test set one request at a time through the live
    queue (8 concurrent clients), like screening traffic would."""
    with cf.ThreadPoolExecutor(8) as ex:
        return np.asarray(list(ex.map(
            lambda im: svc.score_one({"image": im}), images)), np.float32)


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
                               val_per_client=16, test_per_client=32,
                               image_size=32)
    cfg = DenseNetConfig(growth=8, blocks=(2, 2), stem_ch=16, cut_layer=2)
    adapter = cnn_adapter(build_densenet(cfg))
    strat = make_strategy("fl", adapter, lambda: O.adam(3e-4),
                          n_clients=len(clients), device=device)
    state = strat.setup(0)
    rng = np.random.default_rng(0)
    images, labels = pooled_test(clients)

    svc, rounds = None, []
    try:
        for rnd in range(args.epochs):
            state, logs = strat.run(state, [c.train for c in clients], rng,
                                    batch_size=16, n_epochs=1)
            servable = strat.export(state, meta={"round": rnd})
            if svc is None:
                svc = ScreeningService(servable,
                                       image_shape=images.shape[1:],
                                       max_wait_s=0.002)
            else:
                svc.swap(servable)           # in-flight requests finish on
                                             # the old tree, new ones see
                                             # round rnd
            # training-side eval (FL: the same global model everywhere)
            train_scores = np.concatenate(
                strat.scores_all(state, [c.test for c in clients]))
            live = serve_scores(svc, images)
            diff = float(np.abs(live - train_scores).max())
            train_auroc, live_auroc = auroc(labels, train_scores), \
                auroc(labels, live)
            assert diff <= SERVE_BAR, (
                f"round {rnd}: a served score differs from the training "
                f"eval by {diff:.3g} (bar {SERVE_BAR:g}): the service does "
                "not serve this round's model")
            st = svc.stats()
            print(f"round {rnd}: loss={logs[-1].mean_loss:.4f}  "
                  f"AUROC train={train_auroc:.4f} serve={live_auroc:.4f} "
                  f"(max |score diff| {diff:.2g}, v{svc.version})  "
                  f"p50={st['total_p50_ms']:.2f}ms "
                  f"p99={st['total_p99_ms']:.2f}ms")
            rounds.append({"loss": logs[-1].mean_loss,
                           "train_auroc": train_auroc,
                           "serve_auroc": live_auroc, "max_diff": diff,
                           "version": svc.version,
                           "p50_ms": st["total_p50_ms"],
                           "p99_ms": st["total_p99_ms"]})
    finally:
        if svc is not None:
            svc.close()

    # -- the split family deploys through the same path -------------------
    sfl = make_strategy("sflv3_ac", adapter, lambda: O.adam(3e-4),
                        n_clients=len(clients), device=device)
    sstate = sfl.setup(1)
    sstate, _ = sfl.run(sstate, [c.train for c in clients], rng,
                        batch_size=16, n_epochs=1)
    hosp = min(2, len(clients) - 1)
    ref = np.asarray(sfl.scores(sstate, hosp, clients[hosp].test)).ravel()
    export = sfl.export(sstate, client_idx=hosp, meta={"round": 0})
    fd, path = tempfile.mkstemp(suffix=".msgpack")
    os.close(fd)
    try:
        save_servable(path, export)
        servable = load_servable(path, adapter, device=device)
    finally:
        os.remove(path)
    exact = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(servable.params), tree_leaves(export.params)))
    assert exact, "the checkpoint round trip changed a parameter"
    with ScreeningService(servable, image_shape=images.shape[1:]) as svc2:
        got = np.asarray([svc2.score_one({"image": im})
                          for im in clients[hosp].test["image"]], np.float32)
    diff = float(np.abs(got - ref).max())
    assert diff <= SERVE_BAR, (
        f"the re-served export differs from its strategy by {diff:.3g}")
    served = auroc(clients[hosp].test["label"], got)
    print(f"sflv3 export (hospital {hosp} front + shared server) "
          f"round-tripped through {servable.family!r} checkpoint "
          f"bit-exactly and re-served (AUROC {served:.4f}, max |score "
          f"diff| {diff:.2g})")
    return {"rounds": rounds, "checkpoint_exact": exact,
            "sflv3_max_diff": diff, "sflv3_auroc": served}


if __name__ == "__main__":
    main()
