"""Train a small LM with SplitFedv3 on the PyTorch port (the port's
``examples/train_lm_splitfed.py``: the same model, data, schedule and
flags): 4 virtual hospitals, each with its own front segment, share the
middle, on a synthetic Markov token stream, and the loss falls.  The
params are saved with ``repro_torch.train.checkpoint`` in the reference's
file format.  It runs on the CUDA card unless given ``--device cpu``.

  PYTHONPATH=src python examples/train_lm_splitfed_torch.py [--steps 200]
      [--clients 4] [--batch 8] [--seq 64] [--ckpt PATH] [--device cpu]
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import optim as O
from repro_torch.data.synthetic import lm_clients
from repro_torch.device import resolve_device
from repro_torch.launch.train import init_sflv3_params, make_sflv3_train_step
from repro_torch.models.transformer import ModelConfig, TransformerLM
from repro_torch.train import checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)    # per client
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_sflv3_lm.msgpack"))
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ModelConfig(name="quick-lm", arch_type="dense", n_layers=4,
                      d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                      vocab_size=256, cut_layer=1, remat=False,
                      compute_dtype=torch.float32)
    model = TransformerLM.build(cfg)
    params = init_sflv3_params(model, torch.Generator().manual_seed(0),
                               args.clients, device)
    opt = O.adam(O.wsd(3e-3, warmup=20, stable=args.steps // 2,
                       decay=args.steps // 2))
    opt_state = opt.init(params)
    step = make_sflv3_train_step(model, opt, args.clients)

    data = lm_clients(seed=0, vocab=cfg.vocab_size,
                      n_clients=args.clients, seqs_per_client=256,
                      seq_len=args.seq + 1)
    rng = np.random.default_rng(0)

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        toks = np.stack([d[rng.integers(0, len(d), args.batch)]
                         for d in data])            # (C, B, S+1)
        batch = {"tokens": torch.from_numpy(
            toks.reshape(args.clients * args.batch, args.seq + 1)).to(
                device)}
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss={losses[-1]:.4f}  "
                  f"({time.time() - t0:.0f}s)", flush=True)
    checkpoint.save(args.ckpt, params)
    print(f"saved checkpoint -> {args.ckpt}")
    return params, np.asarray(losses)


if __name__ == "__main__":
    main()
