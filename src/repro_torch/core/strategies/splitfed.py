"""SplitFed variants — counterpart of ``repro/core/strategies/splitfed.py``.

* SFLv2 (Thapa et al.): the server segment trained SEQUENTIALLY like SL,
  the client segments synchronized at the end of each epoch by an
  unweighted mean.
* SFLv3 (THE PAPER'S PROPOSAL, Algorithm 1): client segments stay unique
  (like SL), while the server segment is updated with the average of
  per-client gradients computed in parallel, one update per synchronous
  mini-batch step (the batch-synchronous reading of DESIGN.md §3).
  Clients that exhaust their batches wrap around, so the server always
  averages ``n_clients`` gradients.
* SFLv1 (the paper excluded it for hardware reasons): SFLv3's parallel
  server + the unweighted mean of the client segments each epoch.

Under NLS the client segments are the front and the tail, and the means
cover both.  With privacy, SFLv2 steps as SL does; SFLv3/v1 draw every
hospital's noise for the synchronous step, cut noise at every crossing.

Under fixed-size ``participation`` SFLv2 runs as SL does and its sync puts
the sampled hospitals' mean into every hospital's client tree; SFLv3/v1
step the round's K sampled hospitals batch-synchronously, their client
trees and Adam rows gathered out of (and scattered back into) the N
hospitals' (``_run_compiled``; without participation every hospital
fills the slots every round).
"""

from __future__ import annotations

import torch

import numpy as np

from repro_torch.core.aggregate import tree_mean
from repro_torch.core.strategies import engine as ENG
from repro_torch.core.strategies.base import (EpochLog, np_batches,
                                              sflv3_step_fn)
from repro_torch.core.strategies.split import SplitLearning
from repro_torch.obs import telemetry as T
from repro_torch.privacy.dpsgd import step_draws


def _sync_clients(state, n_clients):
    """Every hospital gets the unweighted mean of all client trees."""
    avg = tree_mean(state["clients"])
    state["clients"] = [avg for _ in range(n_clients)]


class SplitFedV2(SplitLearning):
    """Sequential server training + end-of-epoch client averaging."""
    _syncs_clients = True

    def __init__(self, adapter, opt_factory, n_clients, schedule="ac",
                 transport=None, privacy=None, **kw):
        super().__init__(adapter, opt_factory, n_clients, schedule,
                         transport, privacy, **kw)
        self.name = f"sflv2_{schedule}"

    def _end_of_epoch(self, state):
        _sync_clients(state, self.n_clients)


class SplitFedV3(SplitLearning):
    """Unique clients + gradient-averaged parallel server updates (Alg. 1)."""

    def __init__(self, adapter, opt_factory, n_clients, schedule="ac",
                 transport=None, privacy=None, **kw):
        super().__init__(adapter, opt_factory, n_clients, schedule,
                         transport, privacy, **kw)
        if not self.drop_remainder:
            raise ValueError(
                "SplitFedV3/V1 are batch-synchronous: every client ships a "
                "same-shaped batch each step, so drop_remainder=False is "
                "not representable; use drop_remainder=True")
        self.name = f"sflv3_{schedule}"

    def _make_step(self, telemetry=None, n_slots=None):
        """The batch-synchronous step over ``n_slots`` hospitals (a
        participating run's K; None: every hospital)."""
        return sflv3_step_fn(self.adapter, self._opt_c, self._opt_s,
                             n_slots or self.n_clients, self.transport,
                             self.privacy, telemetry)

    def _phases(self, telemetry):
        """The step of a placed run cut into its phases
        (``sflv3_step_fn(phases=True)``), built once per spec."""
        key = ("phases", telemetry)
        if key not in self._obs_steps:
            self._obs_steps[key] = sflv3_step_fn(
                self.adapter, self._opt_c, self._opt_s, self.n_clients,
                self.transport, self.privacy, telemetry, phases=True)
        return self._obs_steps[key]

    def _sync_round_telemetry(self, tel, losses, metrics):
        """Reduce one epoch's ``[S, C]`` synchronous-step taps."""
        losses = np.asarray(losses, np.float64)
        if not losses.size:
            return T.RoundTelemetry(0, {})
        return T.rounds_sync(
            tel, losses[None],
            {k: np.asarray(v, np.float64)[None]
             for k, v in metrics.items()}, self.n_clients)[0]

    def _step_draws(self, step: int, clients, server, batch,
                    hospitals=None, device=None) -> list:
        """One step's per-hospital noise (``privacy.dpsgd.step_draws``) for
        ``hospitals`` (global ids; default every hospital), one per client
        tree of ``clients``: cut noise of every crossing's shapes on
        ``batch`` (one hospital's; batches are never short here), DP noise
        of ``{"c": client tree, "s": server}``'s, on ``device`` (a placed
        chunk's; the strategy's by default)."""
        rows = len(next(iter(batch.values())))
        return step_draws(self.privacy, step,
                          range(self.n_clients) if hospitals is None
                          else hospitals, self._cut_specs(batch, rows),
                          [{"c": cp, "s": server} for cp in clients],
                          device or self.device)

    def _check_batches(self, n_batches, batch_size):
        empty = [c for c, nb in enumerate(n_batches) if not nb]
        if empty:
            raise ValueError(
                f"clients {empty} have fewer than batch_size={batch_size} "
                "train samples; SplitFedV3 needs at least one batch per "
                "client")

    def _run_epoch_stepwise(self, state, client_data, rng, batch_size):
        tel = self._tel
        step = self._observed_step(tel)
        batches = [np_batches(d, batch_size, rng) for d in client_data]
        self._check_batches([len(b) for b in batches], batch_size)
        steps = max(len(b) for b in batches)
        step_losses, mets = [], []
        for s in range(steps):
            # clients that exhausted their data wrap around
            host = [batches[c][s % len(batches[c])]
                    for c in range(self.n_clients)]
            draws = (self._step_draws(self._next_step(), state["clients"],
                                      state["server"], host[0])
                     if self._keyed else None)
            (state["clients"], state["server"], state["c_opts"],
             state["s_opt"], losses, *met) = step(
                state["clients"], state["server"], state["c_opts"],
                state["s_opt"], [self.to_device(b) for b in host], draws)
            self._count_dispatch()
            step_losses.append(losses)
            mets += met
            for c in range(self.n_clients):
                # wrap-around resampling included: every client is touched
                self._dp_account(c, len(client_data[c]["label"]),
                                 batch_size)
            if self.transport is not None:
                for b in host:
                    self.transport.account(self.adapter, b)
        self._record_wire_epoch(batches[0][0], [len(b) for b in batches])
        self._end_of_epoch(state)
        rows = torch.stack(step_losses).cpu().numpy()
        log = EpochLog(rows.reshape(-1).tolist(), steps,
                       client_steps=[steps] * self.n_clients)
        if tel is not None:
            log.telemetry = self._sync_round_telemetry(
                tel, rows, self._host_metrics(mets))
        return state, log

    def _run_compiled(self, state, client_data, rng, batch_size, n_epochs,
                      participation=None):
        """The run on one program (``engine.SyncProgram``): each round's
        sampled hospitals (every hospital without ``participation``) step
        batch-synchronously as many steps as the most batches among them,
        their client trees and Adam rows gathered out of the N hospitals'
        and scattered back.  Step indices are round-major over the full-N
        grid (``NB_N`` steps a round) and each slot draws for its global
        id, so ``Participation(k=N)`` trains exactly as
        ``participation=None``.  Every hospital composes every round at
        the amplified rate over ``NB_N`` steps (the reference's bound,
        conservative when a cohort runs fewer)."""
        self._check_observe(participation)
        tel = self._tel
        part = self._cohort(participation)
        with self._span("pack"):
            batches, pack = ENG.pack_participation_run(
                client_data, batch_size, rng, n_epochs, part, True)
        nbs = pack.n_batches
        self._check_batches(nbs, batch_size)
        NB_N = pack.nb_max
        real = [max(nbs[g] for g in pack.slot_gid[e])
                for e in range(n_epochs)]
        key_idx = np.zeros((n_epochs, NB_N), np.int64)
        if self._keyed:
            for e in range(n_epochs):
                key_idx[e, :real[e]] = (self._key_step + 1 + e * NB_N
                                        + np.arange(real[e]))
            self._key_step += n_epochs * NB_N
        first = pack.epoch(0, batches)
        if self._placed:
            from repro_torch.core.strategies.placed import run_sync
            losses, met = run_sync(self, state, batches, pack, key_idx,
                                   NB_N, self._syncs_clients)
        else:
            losses, met = self._run_program(state, batches, pack, key_idx,
                                            real)
        logs = []
        for e in range(n_epochs):
            sampled = set(int(g) for g in pack.slot_gid[e])
            logs.append(EpochLog(
                losses[e, :real[e]].reshape(-1).tolist(), real[e],
                client_steps=[real[e] if g in sampled else 0
                              for g in range(pack.n_global)]))
            if tel is not None:
                logs[-1].telemetry = self._sync_round_telemetry(
                    tel, losses[e, :real[e]],
                    {k: v[e, :real[e]] for k, v in met.items()})
        for g in range(pack.n_global):
            self._dp_account(g, pack.n_samples[g], batch_size,
                             count=NB_N * n_epochs, q_scale=part.rate)
        if self.transport is not None:
            example = {k: v[0, 0] for k, v in first.batches.items()}
            for g in range(pack.n_global):
                steps = sum(r for r, m in zip(real, pack.part_mask[:, g])
                            if m)
                if steps:
                    self.transport.account(self.adapter, example,
                                           count=steps)
            # the schedule signature: each hospital's batch count, or a
            # participating round's steps for each sampled hospital (the
            # reference's)
            for e in range(n_epochs):
                if participation is None:
                    self._record_wire_epoch(example, nbs)
                    continue
                ids = np.flatnonzero(pack.part_mask[e])
                self._record_wire_epoch(
                    example, [real[e] if pack.part_mask[e, g] else 0
                              for g in range(pack.n_global)],
                    client_set=ids)
        return state, logs

    def _run_program(self, state, batches, pack, key_idx, real):
        """The run on one ``engine.SyncProgram``: the ``[E, NB_N, S]``
        losses and the metrics, read back."""
        first = pack.epoch(0, batches)
        nbs, NB_N = pack.n_batches, pack.nb_max
        prog = ENG.program_for(self, "sync", pack, lambda t: ENG.SyncProgram(
            self, first, state, self._syncs_clients, NB_N, t))
        prog.load(state)
        gids = []

        def begin_round(e):
            gids[:] = pack.slot_gid[e]
            prog.load_round(ENG.sync_rows([nbs[g] for g in gids], NB_N,
                                          real[e]), slot_gid=gids)
        draw = None
        if self._keyed:
            example = {k: v[0, 0] for k, v in first.batches.items()}

            def draw(i, row):
                return self._step_draws(i, prog.clients, prog.server,
                                        example, gids)
        calls = dict(prog.calls)
        with self._dispatching(prog):
            out = ENG.to_host(*prog.run(batches, draw, key_idx, None,
                                        begin_round))
        self._dispatch(prog, calls, pack.n_slots)
        prog.store(state)
        return out


class SplitFedV1(SplitFedV3):
    """Parallel server (like v3) + fed-averaged clients each epoch."""
    _syncs_clients = True

    def __init__(self, adapter, opt_factory, n_clients, schedule="ac",
                 transport=None, privacy=None, **kw):
        super().__init__(adapter, opt_factory, n_clients, schedule,
                         transport, privacy, **kw)
        self.name = f"sflv1_{schedule}"

    def _end_of_epoch(self, state):
        _sync_clients(state, self.n_clients)
