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
"""

from __future__ import annotations

import torch

import numpy as np

from repro_torch.core.schedule import SCHEDULES, schedule_array
from repro_torch.core.strategies import engine as ENG
from repro_torch.core.strategies.base import (EpochLog, Strategy, np_batches,
                                              split_step_fn)


class SplitLearning(Strategy):
    name = "sl"
    #: the epoch ends in the client sync (SFLv2, SFLv1)
    _syncs_clients = False

    def __init__(self, adapter, opt_factory, n_clients, schedule="ac",
                 transport=None, privacy=None, **kw):
        super().__init__(adapter, opt_factory, n_clients, privacy=privacy,
                         **kw)
        self.schedule = schedule
        self.transport = transport
        self.name = f"sl_{schedule}"
        self._opt_c, self._opt_s = opt_factory(), opt_factory()
        self._step = self._make_step()

    def _make_step(self):
        return split_step_fn(self.adapter, self._opt_c, self._opt_s,
                             self.transport, self.privacy)

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
        batches = [np_batches(d, batch_size, rng, self.drop_remainder)
                   for d in client_data]
        order = SCHEDULES[self.schedule]([len(b) for b in batches])
        losses, loss_w = [], []
        client_steps = [0] * self.n_clients
        for c, b in order:
            host = batches[c][b]
            draws = (self._draws(self._next_step(), c, host, batch_size,
                                 {"c": state["clients"][c],
                                  "s": state["server"]})
                     if self._keyed else None)
            (state["clients"][c], state["server"], state["c_opts"][c],
             state["s_opt"], loss) = self._step(
                state["clients"][c], state["server"], state["c_opts"][c],
                state["s_opt"], self.to_device(host), draws=draws)
            losses.append(loss)
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
        return state, EpochLog(losses, len(losses), weights=loss_w,
                               client_steps=client_steps)

    def _run_compiled(self, state, client_data, rng, batch_size, n_epochs):
        if ENG.empty_run(client_data, batch_size, self.drop_remainder):
            return None
        batches, packed = ENG.pack_run(client_data, batch_size, rng,
                                       n_epochs, self.drop_remainder)
        sched = schedule_array(self.schedule, packed.n_batches)
        key_idx = [self._take_key_indices(len(sched)) if self._keyed
                   else None for _ in range(n_epochs)]
        prog = ENG.program_for(
            self, "interleaved", packed, lambda: ENG.InterleavedProgram(
                self, packed, state, sched, self._syncs_clients))
        prog.load(state)
        draw = self._program_draw(packed, {"c": state["clients"][0],
                                           "s": state["server"]})
        losses = prog.run(batches, draw, key_idx).cpu().numpy()
        prog.store(state)
        logs = []
        for e in range(n_epochs):
            flat, loss_w = ENG.scheduled_log(losses[e], sched, packed)
            logs.append(EpochLog(flat, len(flat), weights=loss_w,
                                 client_steps=list(packed.n_batches)))
        self._account_compiled(packed, batch_size, n_epochs)
        return state, logs

    def _account_compiled(self, packed, batch_size, n_epochs):
        """The run's epsilon and wire bytes from shapes and counts: each
        hospital's steps composed in one accountant call, and metered at
        their true batch shape (a kept remainder batch at its short one),
        as the stepwise loop meters them one by one."""
        example = {k: v[0, 0] for k, v in packed.batches.items()}
        for c, nb in enumerate(packed.n_batches):
            self._dp_account(c, packed.n_samples[c], batch_size,
                             count=nb * n_epochs)
            if not nb or self.transport is None:
                continue
            for m, n_steps in zip(*np.unique(packed.step_examples[c],
                                             return_counts=True)):
                b = (example if m == packed.batch_size
                     else {k: v[:m] for k, v in example.items()})
                self.transport.account(self.adapter, b,
                                       count=int(n_steps) * n_epochs)
        for _ in range(n_epochs):
            self._record_wire_epoch(example, packed.n_batches)

    def _record_wire_epoch(self, example_batch, n_batches):
        """Hand the transport this epoch's schedule signature."""
        if self.transport is None or not sum(n_batches):
            return
        self.transport.record_epoch(self.adapter, example_batch,
                                    self.name.rsplit("_", 1)[0],
                                    self.schedule, n_batches)

    def _end_of_epoch(self, state):
        pass

    def params_for_eval(self, state, client_idx):
        ct = state["clients"][client_idx]
        p = {"front": ct["front"], "middle": state["server"]}
        if self.adapter.nls:
            p["tail"] = ct["tail"]
        return p
