"""Centralized training — the paper's benchmark upper bound (§3.6);
counterpart of ``repro/core/strategies/centralized.py``.  The hospitals'
data is pooled and shuffled once per epoch."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.strategies import engine as ENG
from repro_torch.core.strategies.base import (EpochLog, Strategy,
                                              full_step_fn, np_batches)


class Centralized(Strategy):
    name = "centralized"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._opt = self.opt_factory()
        self._step = full_step_fn(self.adapter, self._opt)

    def setup(self, seed=0):
        """One model from ``torch.Generator(seed)`` on the CPU."""
        params = self.adapter.init(torch.Generator().manual_seed(int(seed)),
                                   self.device)
        return {"params": params, "opt": self._opt.init(params)}

    def _run_epoch_stepwise(self, state, client_data, rng, batch_size):
        pooled = _pool(client_data)
        losses, weights = [], []
        for batch in np_batches(pooled, batch_size, rng,
                                self.drop_remainder):
            state["params"], state["opt"], loss = self._step(
                state["params"], state["opt"], self.to_device(batch))
            losses.append(loss)
            weights.append(len(batch["label"]))
        losses = torch.stack(losses).cpu().tolist() if losses else []
        return state, EpochLog(losses, len(losses), weights=weights)

    def _run_compiled(self, state, client_data, rng, batch_size, n_epochs):
        pooled = [_pool(client_data)]
        if ENG.empty_run(pooled, batch_size, self.drop_remainder):
            return None
        batches, packed = ENG.pack_run(pooled, batch_size, rng, n_epochs,
                                       self.drop_remainder)
        prog = ENG.program_for(self, "seq", packed, lambda: ENG.SeqProgram(
            self, packed, state))
        prog.load(state)
        losses = prog.run(batches).cpu().numpy()
        prog.store(state)
        nb = packed.n_batches[0]
        return state, [EpochLog(losses[e].tolist(), nb,
                                weights=list(packed.step_examples[0]))
                       for e in range(n_epochs)]

    def params_for_eval(self, state, client_idx):
        return state["params"]


def _pool(client_data):
    return {k: np.concatenate([d[k] for d in client_data])
            for k in client_data[0]}
