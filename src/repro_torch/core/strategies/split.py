"""Split learning (paper §1.2/§3.4) with the two training schedules —
counterpart of ``repro/core/strategies/split.py``:

* alternate-client (AC): prior art — clients take whole-dataset turns.
* alternate-minibatch (AM): the paper's proposed schedule — mini-batch turns.

Client segments (the front, and the tail under NLS) are unique per client
and never synchronized (paper: "We do not use any form of weight
synchronization").  The server segment and its Adam state are shared and
updated one hospital-batch at a time in schedule order, never batched over
hospitals: that would break the sequential Adam semantics of the shared
server (DESIGN.md §9).

With privacy each step draws its hospital's noise from that hospital's
streams (``Strategy._draws``): cut-layer noise at every crossing and/or
DP-SGD on the joint client + server gradient, and the hospital's
accountant composes its own steps.

Under fixed-size ``participation`` each round runs the full-N schedule
filtered to its K sampled hospitals (``_run_compiled``).
"""

from __future__ import annotations

import torch

import numpy as np

from repro_torch.core.schedule import SCHEDULES, schedule_array
from repro_torch.core.strategies import engine as ENG
from repro_torch.core.strategies.base import (EpochLog, Strategy, np_batches,
                                              split_step_fn)
from repro_torch.obs import telemetry as T


class SplitLearning(Strategy):
    name = "sl"
    #: the epoch ends in the client sync (SFLv2, SFLv1)
    _syncs_clients = False
    _has_cut = True

    def __init__(self, adapter, opt_factory, n_clients, schedule="ac",
                 transport=None, privacy=None, **kw):
        super().__init__(adapter, opt_factory, n_clients, privacy=privacy,
                         **kw)
        self.schedule = schedule
        self.transport = transport
        self.name = f"sl_{schedule}"
        if self.participation is not None and (
                self.participation.kind != "fixed"):
            raise ValueError(
                "the split family supports fixed-size participation only "
                "(Participation(k=...)): the shared-server schedule needs "
                "every slot filled")
        if self.participation is not None and self.observe is not None:
            raise ValueError("participation with observe is not supported "
                             "for the split family")
        self._opt_c, self._opt_s = opt_factory(), opt_factory()
        self._step = self._make_step()

    def _make_step(self, telemetry=None, n_slots=None):
        return split_step_fn(self.adapter, self._opt_c, self._opt_s,
                             self.transport, self.privacy, telemetry)

    def _check_observe(self, participation):
        """The reference's refusal: a participating split-family run is
        never observed."""
        if participation is not None and self._tel is not None:
            raise ValueError("participation with observe is not supported "
                             "for the split family")

    def _round_telemetry(self, tel, losses, metrics, sched):
        """Reduce one epoch's schedule-ordered per-step taps."""
        if not len(sched):
            return T.RoundTelemetry(0, {})
        return T.rounds_scheduled(
            tel, np.asarray(losses, np.float64)[None],
            {k: np.asarray(v, np.float64)[None]
             for k, v in metrics.items()},
            np.asarray(sched), self.n_clients)[0]

    def _client_tree(self, params):
        t = {"front": params["front"]}
        if self.adapter.nls:
            t["tail"] = params["tail"]
        return t

    def setup(self, seed=0):
        """Draw one model per hospital from ``torch.Generator(seed)`` on the
        CPU (the same weights on every device); each hospital keeps its
        client segment(s), the server starts from the first hospital's."""
        gen = torch.Generator().manual_seed(int(seed))
        clients, server = [], None
        for _ in range(self.n_clients):
            params = self.adapter.init(gen, self.device)
            clients.append(self._client_tree(params))
            if server is None:
                server = params["middle"]
        return {"clients": clients, "server": server,
                "c_opts": [self._opt_c.init(c) for c in clients],
                "s_opt": self._opt_s.init(server)}

    def _run_epoch_stepwise(self, state, client_data, rng, batch_size):
        tel = self._tel
        step = self._observed_step(tel)
        batches = [np_batches(d, batch_size, rng, self.drop_remainder)
                   for d in client_data]
        order = SCHEDULES[self.schedule]([len(b) for b in batches])
        losses, loss_w, mets = [], [], []
        client_steps = [0] * self.n_clients
        for c, b in order:
            host = batches[c][b]
            draws = (self._draws(self._next_step(), c, host, batch_size,
                                 {"c": state["clients"][c],
                                  "s": state["server"]})
                     if self._keyed else None)
            (state["clients"][c], state["server"], state["c_opts"][c],
             state["s_opt"], loss, *met) = step(
                state["clients"][c], state["server"], state["c_opts"][c],
                state["s_opt"], self.to_device(host), draws=draws)
            self._count_dispatch()
            losses.append(loss)
            mets += met
            loss_w.append(len(host["label"]))
            client_steps[c] += 1
            self._dp_account(c, len(client_data[c]["label"]), batch_size)
            if self.transport is not None:
                self.transport.account(self.adapter, host)
        if order:
            self._record_wire_epoch(next(bs[0] for bs in batches if bs),
                                    [len(b) for b in batches])
        self._end_of_epoch(state)
        losses = torch.stack(losses).cpu().tolist() if losses else []
        log = EpochLog(losses, len(losses), weights=loss_w,
                       client_steps=client_steps)
        if tel is not None:
            log.telemetry = self._round_telemetry(
                tel, losses, self._host_metrics(mets), order)
        return state, log

    def _run_compiled(self, state, client_data, rng, batch_size, n_epochs,
                      participation=None):
        """The run on one program (``engine.InterleavedProgram``): each
        round runs the full-N schedule filtered to its sampled hospitals
        (every hospital without ``participation``), their relative order
        kept, and only the round's own steps.  A step's noise index is its
        position in the VIRTUAL full-N schedule, so a hospital's draws
        depend only on (round, hospital) and ``Participation(k=N)`` trains
        exactly as ``participation=None``."""
        if ENG.empty_run(client_data, batch_size, self.drop_remainder):
            return None
        self._check_observe(participation)
        tel = self._tel
        part = self._cohort(participation)
        with self._span("pack"):
            batches, pack = ENG.pack_participation_run(
                client_data, batch_size, rng, n_epochs, part,
                self.drop_remainder)
        nbs = pack.n_batches
        full = schedule_array(self.schedule, nbs)
        S_N = len(full)
        rounds = []                     # per round: (slot, batch, position)
        for e in range(n_epochs):
            slot_of = {int(g): s for s, g in enumerate(pack.slot_gid[e])
                       if g >= 0}
            rounds.append([(slot_of[int(c)], int(b), p)
                           for p, (c, b) in enumerate(full)
                           if int(c) in slot_of])
        if not any(rounds):
            return None
        key_idx = np.zeros((n_epochs, S_N), np.int64)
        if self._keyed:
            for e, rows in enumerate(rounds):
                key_idx[e, :len(rows)] = [self._key_step + 1 + e * S_N + p
                                          for _s, _b, p in rows]
            self._key_step += n_epochs * S_N
        first = pack.epoch(0, batches)
        if self._placed:
            from repro_torch.core.strategies.placed import run_interleaved
            losses, met = run_interleaved(self, state, batches, pack,
                                          key_idx, full,
                                          self._syncs_clients)
        else:
            prog = ENG.program_for(
                self, "interleaved", pack, lambda t: ENG.InterleavedProgram(
                    self, first, state, S_N, self._syncs_clients, t))
            prog.load(state)

            def begin_round(e):
                prog.load_round(
                    ENG.interleaved_rows([(s, b) for s, b, _p in rounds[e]],
                                         pack.nb_max, pack.slot_gid[e]),
                    None if pack.ex_weights is None
                    else pack.ex_weights[e], slot_gid=pack.slot_gid[e])
            draw = self._program_draw(first, {"c": state["clients"][0],
                                              "s": state["server"]})
            calls = dict(prog.calls)
            with self._dispatching(prog):
                losses, met = ENG.to_host(*prog.run(batches, draw, key_idx,
                                                    None, begin_round))
            self._dispatch(prog, calls, 1)
            prog.store(state)
        logs = []
        for e, rows in enumerate(rounds):
            gid = pack.slot_gid[e]
            flat, loss_w = ENG.scheduled_log(
                losses[e, :len(rows)], [(s, b) for s, b, _p in rows],
                pack.epoch(e, batches))
            csteps = [0] * pack.n_global
            for s, _b, _p in rows:
                csteps[gid[s]] += 1
            logs.append(EpochLog(flat, len(rows), weights=loss_w,
                                 client_steps=csteps))
            if tel is not None:
                logs[-1].telemetry = self._round_telemetry(
                    tel, losses[e, :len(rows)],
                    {k: v[e, :len(rows)] for k, v in met.items()},
                    [(gid[s], b) for s, b, _p in rows])
        # amplified RDP: every hospital composes every round at rate K/N
        # over the steps it runs when sampled
        for g in range(pack.n_global):
            if nbs[g]:
                self._dp_account(g, pack.n_samples[g], batch_size,
                                 count=nbs[g] * n_epochs,
                                 q_scale=part.rate)
        # wire: only the sampled clients' transfers exist, per round
        if self.transport is not None:
            example = {k: v[0, 0] for k, v in first.batches.items()}
            for g in range(pack.n_global):
                sampled = int(pack.part_mask[:, g].sum())
                if nbs[g] and sampled:
                    self._account_steps(example, pack.batch_size,
                                        pack.step_examples[g], sampled)
            for e in range(n_epochs):
                ids = np.flatnonzero(pack.part_mask[e])
                counts = [nbs[g] if pack.part_mask[e, g] else 0
                          for g in range(pack.n_global)]
                self._record_wire_epoch(
                    example, counts,
                    client_set=None if participation is None else ids)
        return state, logs

    def _account_steps(self, example, batch_size, step_examples, n_epochs):
        """Meter one hospital's steps at their true batch shape (a kept
        remainder batch at its short one), ``n_epochs`` times (the rounds
        it was sampled in)."""
        for m, n_steps in zip(*np.unique(step_examples, return_counts=True)):
            b = (example if m == batch_size
                 else {k: v[:m] for k, v in example.items()})
            self.transport.account(self.adapter, b,
                                   count=int(n_steps) * n_epochs)

    def _record_wire_epoch(self, example_batch, n_batches,
                           client_set=None):
        """Hand the transport this epoch's schedule signature
        (``client_set``: a participating round's sampled clients)."""
        if self.transport is None or not sum(n_batches):
            return
        self.transport.record_epoch(self.adapter, example_batch,
                                    self.name.rsplit("_", 1)[0],
                                    self.schedule, n_batches,
                                    client_set=client_set)

    def _end_of_epoch(self, state):
        pass

    def params_for_eval(self, state, client_idx):
        ct = state["clients"][client_idx]
        p = {"front": ct["front"], "middle": state["server"]}
        if self.adapter.nls:
            p["tail"] = ct["tail"]
        return p
