"""Federated learning with FedAvg (paper §1.1/§3.3) — counterpart of
``repro/core/strategies/federated.py``.

One federated round == one epoch (as in the paper): the global model is
pushed to every client, each client runs one local epoch with a fresh Adam
of its own, and the server aggregates the resulting parameters with a
data-size-weighted average (``core.aggregate.WeightedMean``).
"""

from __future__ import annotations

import torch

from repro_torch.core.aggregate import WeightedMean
from repro_torch.core.strategies import engine as ENG
from repro_torch.core.strategies.base import (EpochLog, Strategy,
                                              full_step_fn, np_batches)


class FedAvg(Strategy):
    name = "fl"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._opt = self.opt_factory()
        self._step = full_step_fn(self.adapter, self._opt)
        self._agg = WeightedMean()

    def setup(self, seed=0):
        """One global model from ``torch.Generator(seed)`` on the CPU."""
        return {"params": self.adapter.init(
            torch.Generator().manual_seed(int(seed)), self.device)}

    def _run_epoch_stepwise(self, state, client_data, rng, batch_size):
        locals_, weights, losses, loss_w, client_steps = [], [], [], [], []
        for data in client_data:
            p = state["params"]                    # start from global
            opt_state = self._opt.init(p)          # fresh optimizer per round
            steps = 0
            for batch in np_batches(data, batch_size, rng,
                                    self.drop_remainder):
                p, opt_state, loss = self._step(p, opt_state,
                                                self.to_device(batch))
                losses.append(loss)
                loss_w.append(len(batch["label"]))
                steps += 1
            locals_.append(p)
            weights.append(len(data["label"]))
            client_steps.append(steps)
        state["params"] = self._agg.aggregate_trees(locals_, weights,
                                                    prev=state["params"])
        losses = torch.stack(losses).cpu().tolist() if losses else []
        return state, EpochLog(losses, len(losses), weights=loss_w,
                               client_steps=client_steps)

    def _run_compiled(self, state, client_data, rng, batch_size, n_epochs):
        if ENG.empty_run(client_data, batch_size, self.drop_remainder):
            return None
        batches, packed = ENG.pack_run(client_data, batch_size, rng,
                                       n_epochs, self.drop_remainder)
        prog = ENG.program_for(self, "fl", packed, lambda: ENG.FLProgram(
            self, packed, state))
        prog.load(state)
        losses = prog.run(batches).cpu().numpy()
        prog.store(state)
        logs = []
        for e in range(n_epochs):
            flat, loss_w = ENG.client_major_log(losses[e], packed)
            logs.append(EpochLog(flat, len(flat), weights=loss_w,
                                 client_steps=list(packed.n_batches)))
        return state, logs

    def params_for_eval(self, state, client_idx):
        return state["params"]
