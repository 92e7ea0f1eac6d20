"""The split-learning family's shared pieces — counterpart of
``repro/core/strategies/split.py``.

Client segments are unique per hospital and never synchronized; the server
segment is shared.  This slice ports what SplitFedv3 inherits (client
trees, wire-epoch recording, eval params); plain split learning's own
alternate-client / alternate-minibatch training is ROADMAP M5.
"""

from __future__ import annotations

from repro_torch.core.strategies.base import Strategy


class SplitLearning(Strategy):
    name = "sl"

    def __init__(self, adapter, opt_factory, n_clients, schedule="ac",
                 transport=None, **kw):
        super().__init__(adapter, opt_factory, n_clients, **kw)
        self.schedule = schedule
        self.transport = transport
        self.name = f"sl_{schedule}"

    def _client_tree(self, params):
        return {"front": params["front"]}

    def _record_wire_epoch(self, example_batch, n_batches):
        """Hand the transport this epoch's schedule signature."""
        if self.transport is None or not sum(n_batches):
            return
        self.transport.record_epoch(self.adapter, example_batch,
                                    self.name.rsplit("_", 1)[0],
                                    self.schedule, n_batches)

    def params_for_eval(self, state, client_idx):
        return {"front": state["clients"][client_idx]["front"],
                "middle": state["server"]}
