"""Federated learning with FedAvg (paper §1.1/§3.3) — counterpart of
``repro/core/strategies/federated.py``.

One federated round == one epoch (as in the paper): the global model is
pushed to every client, each client runs one local epoch with a fresh Adam
of its own, and the server aggregates the resulting parameters with a
data-size-weighted average (``core.aggregate.WeightedMean``).

Under DP-SGD every local step is the DP estimator, its noise drawn from
the hospital's own streams, and each hospital's accountant composes its
own steps.  With ``privacy.secagg`` the round is pairwise-mask secure
aggregation (``core.aggregate.SecAggregator`` over ``privacy.secagg``): a
host-side protocol, so the compiled engine replays its captured local
steps and aggregates on the host after each round, as the reference keeps
its per-round path under secagg.
"""

from __future__ import annotations

import torch

from repro_torch.core.aggregate import SecAggregator, WeightedMean
from repro_torch.core.strategies import engine as ENG
from repro_torch.core.strategies.base import (EpochLog, Strategy,
                                              full_step_fn, np_batches)


class FedAvg(Strategy):
    name = "fl"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._opt = self.opt_factory()
        self._step = full_step_fn(self.adapter, self._opt, self.privacy)
        self._secagg = self.privacy is not None and self.privacy.secagg
        if self._secagg:
            from repro_torch.privacy.secagg import SecAgg
            self.secagg = SecAgg(self.n_clients, seed=self.privacy.seed)
            self._agg = SecAggregator(self.secagg)
        else:
            self._agg = WeightedMean()

    def setup(self, seed=0):
        """One global model from ``torch.Generator(seed)`` on the CPU."""
        return {"params": self.adapter.init(
            torch.Generator().manual_seed(int(seed)), self.device)}

    def _run_epoch_stepwise(self, state, client_data, rng, batch_size):
        locals_, weights, losses, loss_w, client_steps = [], [], [], [], []
        for c, data in enumerate(client_data):
            p = state["params"]                    # start from global
            opt_state = self._opt.init(p)          # fresh optimizer per round
            n = len(data["label"])
            steps = 0
            for batch in np_batches(data, batch_size, rng,
                                    self.drop_remainder):
                draws = (self._draws(self._next_step(), c, batch,
                                     batch_size, p)
                         if self._keyed else None)
                p, opt_state, loss = self._step(p, opt_state,
                                                self.to_device(batch),
                                                draws=draws)
                losses.append(loss)
                loss_w.append(len(batch["label"]))
                steps += 1
                self._dp_account(c, n, batch_size)
            locals_.append(p)
            weights.append(n)
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
        key_idx = [ENG.key_index_grid(self, packed).reshape(-1)
                   for _ in range(n_epochs)]
        prog = ENG.program_for(self, "fl", packed, lambda: ENG.FLProgram(
            self, packed, state, in_graph_round=not self._secagg))
        prog.load(state)
        end_round = ((lambda: prog.host_round(self._agg.aggregate_trees))
                     if self._secagg else None)
        losses = prog.run(batches, self._program_draw(packed, prog.glob),
                          key_idx, end_round).cpu().numpy()
        prog.store(state)
        logs = []
        for e in range(n_epochs):
            flat, loss_w = ENG.client_major_log(losses[e], packed)
            logs.append(EpochLog(flat, len(flat), weights=loss_w,
                                 client_steps=list(packed.n_batches)))
        for c, nb in enumerate(packed.n_batches):
            self._dp_account(c, packed.n_samples[c], batch_size,
                             count=nb * n_epochs)
        return state, logs

    def params_for_eval(self, state, client_idx):
        return state["params"]
