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
from repro_torch.obs import telemetry as T
from repro_torch.core.strategies.base import (EpochLog, Strategy,
                                              full_step_fn, np_batches)


class Centralized(Strategy):
    name = "centralized"
    shared_eval_params = True
    _eps_pooled = True

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._opt = self.opt_factory()
        self._step = self._make_step()

    def _make_step(self, telemetry=None, n_slots=None):
        return full_step_fn(self.adapter, self._opt, self.privacy,
                            telemetry)

    def _round_telemetry(self, tel, losses, metrics):
        """Reduce one pooled epoch's per-step taps (the centralized
        trainer is a single pooled 'hospital': one row)."""
        nb = len(losses)
        if nb == 0:
            return T.RoundTelemetry(0, {})
        arr = np.asarray(losses, np.float64)[None, None]
        mets = {k: np.asarray(v, np.float64)[None, None]
                for k, v in metrics.items()}
        return T.rounds_client_major(tel, arr, mets,
                                     np.ones((1, nb), bool), 1)[0]

    def setup(self, seed=0):
        """One model from ``torch.Generator(seed)`` on the CPU."""
        params = self.adapter.init(torch.Generator().manual_seed(int(seed)),
                                   self.device)
        return {"params": params, "opt": self._opt.init(params)}

    def _run_epoch_stepwise(self, state, client_data, rng, batch_size):
        pooled = _pool(client_data)
        n_pooled = len(pooled["label"])
        tel = self._tel
        step = self._observed_step(tel)
        losses, weights, mets = [], [], []
        for batch in np_batches(pooled, batch_size, rng,
                                self.drop_remainder):
            draws = (self._draws(self._next_step(), 0, batch, batch_size,
                                 state["params"]) if self._keyed else None)
            state["params"], state["opt"], loss, *met = step(
                state["params"], state["opt"], self.to_device(batch),
                draws=draws)
            self._count_dispatch()
            losses.append(loss)
            mets += met
            weights.append(len(batch["label"]))
            for c in range(self.n_clients):
                self._dp_account(c, n_pooled, batch_size)
        losses = torch.stack(losses).cpu().tolist() if losses else []
        log = EpochLog(losses, len(losses), weights=weights)
        if tel is not None:
            log.telemetry = self._round_telemetry(tel, losses,
                                                  self._host_metrics(mets))
        return state, log

    def _run_compiled(self, state, client_data, rng, batch_size, n_epochs,
                      participation=None):
        pooled = [_pool(client_data)]
        if ENG.empty_run(pooled, batch_size, self.drop_remainder):
            return None
        tel = self._tel
        with self._span("pack"):
            batches, packed = ENG.pack_run(pooled, batch_size, rng,
                                           n_epochs, self.drop_remainder)
        nb = packed.n_batches[0]
        key_idx = [self._take_key_indices(nb) if self._keyed else None
                   for _ in range(n_epochs)]
        prog = ENG.program_for(self, "seq", packed, lambda t: ENG.SeqProgram(
            self, packed, state, t))
        prog.load(state)
        calls = dict(prog.calls)
        with self._dispatching(prog):
            losses, met = ENG.to_host(*prog.run(
                batches, self._program_draw(packed, prog.params, 0),
                key_idx))
        self._dispatch(prog, calls, 1)
        prog.store(state)
        for c in range(self.n_clients):
            self._dp_account(c, packed.n_samples[0], batch_size,
                             count=nb * n_epochs)
        logs = [EpochLog(losses[e].tolist(), nb,
                         weights=list(packed.step_examples[0]))
                for e in range(n_epochs)]
        if tel is not None:
            for e, log in enumerate(logs):
                log.telemetry = self._round_telemetry(
                    tel, losses[e], {k: v[e] for k, v in met.items()})
        return state, logs

    def params_for_eval(self, state, client_idx):
        return state["params"]


def _pool(client_data):
    return {k: np.concatenate([d[k] for d in client_data])
            for k in client_data[0]}
