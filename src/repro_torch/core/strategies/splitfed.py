"""SplitFedv3 (THE PAPER'S PROPOSAL, Algorithm 1) — counterpart of
``repro/core/strategies/splitfed.py`` on the stepwise engine.

Client segments stay unique (like SL), while the server segment is updated
with the average of per-client gradients computed in parallel, one update
per synchronous mini-batch step (the batch-synchronous reading of
DESIGN.md §3).  Clients that exhaust their batches wrap around, so the
server always averages ``n_clients`` gradients.
"""

from __future__ import annotations

import torch

from repro_torch.core.strategies.base import EpochLog, np_batches, \
    sflv3_step_fn
from repro_torch.core.strategies.split import SplitLearning


class SplitFedV3(SplitLearning):
    """Unique clients + gradient-averaged parallel server updates (Alg. 1)."""

    def __init__(self, adapter, opt_factory, n_clients, schedule="ac",
                 transport=None, **kw):
        super().__init__(adapter, opt_factory, n_clients, schedule,
                         transport, **kw)
        self.name = f"sflv3_{schedule}"
        self._opt_c, self._opt_s = opt_factory(), opt_factory()
        self._step3 = sflv3_step_fn(adapter, self._opt_c, self._opt_s,
                                    n_clients, transport)

    def setup(self, seed=0):
        """Draw one model per hospital from ``torch.Generator(seed)`` on the
        CPU (the same weights on every device); each hospital keeps its
        client segment, the server starts from the first hospital's."""
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

    def _check_batches(self, n_batches, batch_size):
        empty = [c for c, nb in enumerate(n_batches) if not nb]
        if empty:
            raise ValueError(
                f"clients {empty} have fewer than batch_size={batch_size} "
                "train samples; SplitFedV3 needs at least one batch per "
                "client")

    def run_epoch(self, state, client_data, rng, batch_size):
        batches = [np_batches(d, batch_size, rng) for d in client_data]
        self._check_batches([len(b) for b in batches], batch_size)
        steps = max(len(b) for b in batches)
        step_losses = []
        for s in range(steps):
            # clients that exhausted their data wrap around
            host = [batches[c][s % len(batches[c])]
                    for c in range(self.n_clients)]
            (state["clients"], state["server"], state["c_opts"],
             state["s_opt"], losses) = self._step3(
                state["clients"], state["server"], state["c_opts"],
                state["s_opt"], [self.to_device(b) for b in host])
            step_losses.append(losses)
            if self.transport is not None:
                for b in host:
                    self.transport.account(self.adapter, b)
        self._record_wire_epoch(batches[0][0], [len(b) for b in batches])
        losses = (torch.stack(step_losses).reshape(-1).cpu().tolist()
                  if step_losses else [])
        return state, EpochLog(losses, steps,
                               client_steps=[steps] * self.n_clients)
