"""Centralized training — the paper's benchmark upper bound (§3.6);
counterpart of ``repro/core/strategies/centralized.py``.  The hospitals'
data is pooled and shuffled once per epoch.

Under DP-SGD the pooled set is one hospital to the noise streams
(hospital field 0), and every hospital's records sit in it, so each
hospital's accountant composes every step at the pooled sampling rate,
as the reference's do."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.strategies import engine as ENG
from repro_torch.core.strategies.base import (EpochLog, Strategy,
                                              full_step_fn, np_batches)


class Centralized(Strategy):
    name = "centralized"
    shared_eval_params = True

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._opt = self.opt_factory()
        self._step = full_step_fn(self.adapter, self._opt, self.privacy)

    def setup(self, seed=0):
        """One model from ``torch.Generator(seed)`` on the CPU."""
        params = self.adapter.init(torch.Generator().manual_seed(int(seed)),
                                   self.device)
        return {"params": params, "opt": self._opt.init(params)}

    def _run_epoch_stepwise(self, state, client_data, rng, batch_size):
        pooled = _pool(client_data)
        n_pooled = len(pooled["label"])
        losses, weights = [], []
        for batch in np_batches(pooled, batch_size, rng,
                                self.drop_remainder):
            draws = (self._draws(self._next_step(), 0, batch, batch_size,
                                 state["params"]) if self._keyed else None)
            state["params"], state["opt"], loss = self._step(
                state["params"], state["opt"], self.to_device(batch),
                draws=draws)
            losses.append(loss)
            weights.append(len(batch["label"]))
            for c in range(self.n_clients):
                self._dp_account(c, n_pooled, batch_size)
        losses = torch.stack(losses).cpu().tolist() if losses else []
        return state, EpochLog(losses, len(losses), weights=weights)

    def _run_compiled(self, state, client_data, rng, batch_size, n_epochs,
                      participation=None):
        pooled = [_pool(client_data)]
        if ENG.empty_run(pooled, batch_size, self.drop_remainder):
            return None
        batches, packed = ENG.pack_run(pooled, batch_size, rng, n_epochs,
                                       self.drop_remainder)
        nb = packed.n_batches[0]
        key_idx = [self._take_key_indices(nb) if self._keyed else None
                   for _ in range(n_epochs)]
        prog = ENG.program_for(self, "seq", packed, lambda: ENG.SeqProgram(
            self, packed, state))
        prog.load(state)
        losses = prog.run(batches, self._program_draw(packed, prog.params, 0),
                          key_idx).cpu().numpy()
        prog.store(state)
        for c in range(self.n_clients):
            self._dp_account(c, packed.n_samples[0], batch_size,
                             count=nb * n_epochs)
        return state, [EpochLog(losses[e].tolist(), nb,
                                weights=list(packed.step_examples[0]))
                       for e in range(n_epochs)]

    def params_for_eval(self, state, client_idx):
        return state["params"]


def _pool(client_data):
    return {k: np.concatenate([d[k] for d in client_data])
            for k in client_data[0]}
