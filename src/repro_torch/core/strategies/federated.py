"""Federated learning with FedAvg (paper §1.1/§3.3) — counterpart of
``repro/core/strategies/federated.py``.

One federated round == one epoch (as in the paper): the global model is
pushed to every client, each client runs one local epoch with a fresh Adam
of its own, and the server aggregates the resulting parameters with the
strategy's ``core.aggregate.Aggregator``: the data-size-weighted average
(``WeightedMean``) unless ``aggregator=`` names another rule.  On the
compiled engine the rule runs inside the captured round body.

Under ``participation`` (``core.participation``) each round trains only
its sampled hospitals, packed into a fixed slot axis (without it, all N
hospitals fill the slots every round); the rule reduces the slots, empty
ones at zero weight.

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

import numpy as np

from repro_torch.core.aggregate import SecAggregator, make_aggregator
from repro_torch.core.strategies import engine as ENG
from repro_torch.core.strategies.base import (EpochLog, Strategy,
                                              full_step_fn, np_batches)
from repro_torch.obs import telemetry as T
from repro_torch.tree import stack_trees


class FedAvg(Strategy):
    name = "fl"
    shared_eval_params = True

    def __init__(self, *args, aggregator=None, **kw):
        """``aggregator``: the rule's spec (``core.aggregate.
        make_aggregator``), the data-size-weighted mean when None."""
        super().__init__(*args, **kw)
        self._opt = self.opt_factory()
        self._step = self._make_step()
        if self.privacy is not None and self.privacy.secagg:
            if aggregator is not None:
                raise ValueError("aggregator= cannot be combined with "
                                 "privacy.secagg (secure aggregation IS "
                                 "the aggregation rule)")
            if self.participation is not None:
                raise ValueError("participation= with privacy.secagg is "
                                 "not supported (the pairwise-mask "
                                 "protocol assumes a fixed cohort)")
            from repro_torch.privacy.secagg import SecAgg
            self.secagg = SecAgg(self.n_clients, seed=self.privacy.seed)
            self._agg = SecAggregator(self.secagg)
        else:
            self._agg = make_aggregator(aggregator)

    def _make_step(self, telemetry=None, n_slots=None):
        return full_step_fn(self.adapter, self._opt, self.privacy,
                            telemetry)

    def setup(self, seed=0):
        """One global model from ``torch.Generator(seed)`` on the CPU."""
        return {"params": self.adapter.init(
            torch.Generator().manual_seed(int(seed)), self.device)}

    def _run_epoch_stepwise(self, state, client_data, rng, batch_size):
        tel = self._tel
        step = self._observed_step(tel)
        locals_, weights, losses, loss_w, client_steps = [], [], [], [], []
        mets = []
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
                p, opt_state, loss, *met = step(p, opt_state,
                                                self.to_device(batch),
                                                draws=draws)
                self._count_dispatch()
                losses.append(loss)
                mets += met
                loss_w.append(len(batch["label"]))
                steps += 1
                self._dp_account(c, n, batch_size)
            locals_.append(p)
            weights.append(n)
            client_steps.append(steps)
        old = state["params"]
        state["params"] = self._agg.aggregate_trees(locals_, weights,
                                                    prev=old)
        losses = torch.stack(losses).cpu().tolist() if losses else []
        log = EpochLog(losses, len(losses), weights=loss_w,
                       client_steps=client_steps)
        if tel is not None:
            arr, mask = T.pack_client_major(losses, client_steps)
            metrics = {k: T.pack_client_major(list(v), client_steps)[0][None]
                       for k, v in self._host_metrics(mets).items()}
            extra = None
            if tel.update_cosine:
                cos = T.update_cosine(stack_trees(locals_), old,
                                      state["params"])
                extra = {"update_cosine": cos.cpu().numpy()[None]}
            log.telemetry = T.rounds_client_major(
                tel, arr[None], metrics, mask, self.n_clients, extra)[0]
        return state, log

    def _run_compiled(self, state, client_data, rng, batch_size, n_epochs,
                      participation=None):
        """The run on one program over the slot axis (``engine.FLProgram``
        with per-round buffers).  The step indices of the noise streams
        are laid out over the VIRTUAL full-N run: round r, hospital g,
        local step t gets the index the run without participation gives
        it, so a hospital's draws depend only on (round, hospital) and
        ``Participation(k=N)`` trains exactly as ``participation=None``."""
        if ENG.empty_run(client_data, batch_size, self.drop_remainder):
            return None
        tel = self._tel
        part = self._cohort(participation)
        with self._span("pack"):
            batches, pack = ENG.pack_participation_run(
                client_data, batch_size, rng, n_epochs, part,
                self.drop_remainder)
        nbs, S, NB = pack.n_batches, pack.n_slots, pack.nb_max
        T_N = int(sum(nbs))
        prefix = np.concatenate([[0], np.cumsum(nbs)[:-1]]).astype(np.int64)
        key_idx = np.zeros((n_epochs, S, NB), np.int64)
        if self._keyed:
            base0 = self._key_step
            for e in range(n_epochs):
                for s, g in enumerate(pack.slot_gid[e]):
                    if g >= 0 and nbs[g]:
                        key_idx[e, s, :nbs[g]] = (
                            base0 + 1 + e * T_N + prefix[g]
                            + np.arange(nbs[g], dtype=np.int64))
            self._key_step += n_epochs * T_N
        if self._placed:
            from repro_torch.core.strategies.placed import run_fl
            losses, met = run_fl(self, state, batches, pack, key_idx)
        else:
            losses, met = self._run_program(state, batches, pack, key_idx)
        logs = []
        for e in range(n_epochs):
            flat, loss_w = ENG.client_major_log(losses[e],
                                                pack.epoch(e, batches))
            csteps = [0] * pack.n_global
            for g in pack.slot_gid[e]:
                if g >= 0:
                    csteps[g] = nbs[g]
            logs.append(EpochLog(flat, len(flat), weights=loss_w,
                                 client_steps=csteps))
        if tel is not None:
            extra = ({"update_cosine": met.pop("update_cosine")}
                     if "update_cosine" in met else None)
            grid = (n_epochs, S, NB)
            losses = losses.reshape(grid)
            met = {k: v.reshape(grid) for k, v in met.items()}
            rounds = (T.rounds_client_major(tel, losses, met, pack.mask[0],
                                            self.n_clients, extra)
                      if participation is None else
                      T.rounds_participation(tel, losses, met, pack, extra))
            for log, r in zip(logs, rounds):
                log.telemetry = r
        if participation is not None and part.kind != "schedule":
            # the would-be step counts the epsilon series composes over
            self._last_part_nbs = list(nbs)
        # RDP: with sampling randomness EVERY hospital composes EVERY round
        # at the amplified rate (q_round * q_batch) over its would-be step
        # count; a deterministic schedule composes the realized rounds only,
        # at the plain batch rate
        for g in range(pack.n_global):
            if part.kind == "schedule":
                cnt, q_scale = int(pack.part_mask[:, g].sum()) * nbs[g], 1.0
            else:
                cnt, q_scale = nbs[g] * n_epochs, part.rate
            if cnt:
                self._dp_account(g, pack.n_samples[g], batch_size,
                                 count=cnt, q_scale=q_scale)
        return state, logs

    def _run_program(self, state, batches, pack, key_idx):
        """The run on one ``engine.FLProgram``: the ``[E, S * NB]`` losses
        and the metrics, read back."""
        first = pack.epoch(0, batches)
        prog = ENG.program_for(self, "fl", pack, lambda t: ENG.FLProgram(
            self, first, state, self._agg.scan_compatible, t))
        prog.load(state)

        def begin_round(e):
            prog.load_round(ENG.fl_rows(pack.mask[e], pack.slot_gid[e]),
                            None if pack.ex_weights is None
                            else pack.ex_weights[e], agg_w=pack.agg_w[e],
                            staleness=pack.staleness[e],
                            slot_gid=pack.slot_gid[e])
        calls = dict(prog.calls)
        with self._dispatching(prog):
            out = ENG.to_host(*prog.run(
                batches, self._program_draw(first, prog.glob),
                key_idx.reshape(len(key_idx), -1), self._end_round(prog),
                begin_round))
        self._dispatch(prog, calls, 1)
        prog.store(state)
        return out

    def _end_round(self, prog):
        """The host round a rule that cannot run in a graph (secure
        aggregation) takes after each round's replays; None otherwise."""
        if self._agg.scan_compatible:
            return None
        return lambda: prog.host_round(self._agg.aggregate_trees)

    def params_for_eval(self, state, client_idx):
        return state["params"]
