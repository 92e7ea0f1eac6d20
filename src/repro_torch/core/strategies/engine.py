"""The compiled engine — counterpart of ``repro/core/strategies/engine.py``.

The stepwise engine calls one step per mini-batch from a Python loop, and
on the card its time goes to host dispatch: thousands of launches a step,
each issued by Python.  The reference's answer is to lower a whole epoch,
or a whole ``Strategy.run``, into one XLA program.  The PyTorch answer here
keeps the reference's semantics and replaces the program by ONE captured
CUDA graph of the step, replayed:

  * **pad-and-mask packing** (``pack_epoch``/``pack_run``, the reference's
    code): each hospital's shuffled epoch becomes rectangular ``[C, NB, B,
    ...]`` arrays with a ``[C, NB]`` validity mask, drawn from the host rng
    exactly as the stepwise ``np_batches`` draws; with
    ``drop_remainder=False`` the short final batch becomes per-example
    weights (``full_loss(weights=)``) instead of a ragged shape;
  * **static buffers**: a program owns device buffers for the state (the
    strategy's params and optimizer states, hospital axis stacked where
    the step indexes it), one epoch of packed batches, the step table
    (each step's batch, hospital and flags as int64 rows), the losses and
    a device step counter ``t``.  The step reads its row of the table by
    ``t``, gathers its batch and hospital slice by device index
    (``tree_take``/``tree_put``), runs the SAME step function the stepwise
    engine calls, writes the results back into the buffers and advances
    ``t``.  So one capture serves every step, epoch and run of a layout;
  * **masked steps are no-ops** (``tree_select``): FL steps over the whole
    ``[C, NB]`` grid, and a padding step leaves params and Adam's count
    alone;
  * **capture** (``Program``, the role ``jax.jit`` plays): on the card the
    step is run once on a side stream to warm up (its writes are then
    undone), captured into a ``torch.cuda.CUDAGraph`` and replayed; a
    failed capture or replay raises, nothing falls back to eager.  On the
    CPU the same body runs eagerly over the same buffers;
  * **noise outside the graph**: a CUDA generator cannot be re-seeded
    inside a replay, so before each replay of a private step the
    per-(step, hospital, purpose) streams of ``privacy.dpsgd`` (seeded from
    the step indices ``Strategy._take_key_indices`` reserved up front, the
    hospital read from the host copy of the step table) fill static noise
    buffers: both engines draw the same noise.  FL reserves indices for
    real cells only (``key_index_grid``); a masked cell draws nothing;
  * **round boundaries** (the FedAvg weighted mean, the SFLv2/v1 client
    sync) are a second captured body, replayed once an epoch; secure
    aggregation is a host-side protocol and runs on the host instead
    (``_PackedProgram.run``'s ``end_round``);
  * **analytic accounting**: wire bytes and epsilon of a whole run are
    composed on the host from shapes and counts (``Transport.account(
    count=)``, ``Strategy._dp_account(count=)``).

A whole ``Strategy.run(n_epochs)`` packs every epoch up front, then for
each epoch copies its batches into the static buffer and replays; the
losses of the run come back from one device buffer at its end.
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from repro_torch.core.aggregate import (stacked_mean_sync,
                                        stacked_weighted_mean, tree_mean)
from repro_torch.kernels import build as B
from repro_torch.tree import (stack_trees, tree_leaves, tree_map, tree_put,
                              tree_select, tree_take)


# ---------------------------------------------------------------------------
# pad-and-mask epoch packing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedEpoch:
    """One epoch of every hospital's data in rectangular form.

    ``batches[k]`` has shape ``[n_clients, nb_max, batch, ...]``; rows past
    a hospital's real data are zero padding flagged invalid by ``mask``.
    ``ex_weights`` (only with ``drop_remainder=False``) carries per-example
    validity for the final short batch of each hospital.
    """
    batches: dict
    mask: np.ndarray                       # [C, NB] bool
    ex_weights: np.ndarray | None          # [C, NB, B] float32
    n_batches: list
    step_examples: list                    # per client: valid-example counts
    n_samples: list
    batch_size: int

    @property
    def nb_max(self) -> int:
        return self.mask.shape[1]


def _client_batch_count(n: int, batch_size: int,
                        drop_remainder: bool) -> tuple[int, int, int]:
    """``(nb, nb_full, rem)`` for one hospital of ``n`` samples — the
    batching rule of ``np_batches``, shared by ``pack_epoch`` and
    ``empty_run``."""
    nb_full, rem = divmod(n, batch_size)
    return nb_full + (1 if rem and not drop_remainder else 0), nb_full, rem


def pack_epoch(client_data: list, batch_size: int,
               rng: np.random.Generator | None,
               drop_remainder: bool = True) -> PackedEpoch:
    """Shuffle + pack every hospital's epoch (mirrors ``np_batches``): the
    shuffles consume ``rng`` in hospital order, exactly the draws the
    stepwise engine makes, so both engines train on the same batches."""
    n_batches, n_samples, step_examples, order = [], [], [], []
    for d in client_data:
        n = len(next(iter(d.values())))
        idx = np.arange(n)
        if rng is not None:
            rng.shuffle(idx)
        nb, nb_full, rem = _client_batch_count(n, batch_size,
                                               drop_remainder)
        order.append(idx)
        n_batches.append(nb)
        n_samples.append(n)
        step_examples.append([batch_size] * nb_full
                             + ([rem] if nb > nb_full else []))
    NB = max(n_batches, default=0)
    C = len(client_data)

    batches = {}
    for k in client_data[0]:
        proto = client_data[0][k]
        out = np.zeros((C, NB * batch_size, *proto.shape[1:]), proto.dtype)
        for c, d in enumerate(client_data):
            used = (n_batches[c] * batch_size if drop_remainder
                    else n_samples[c])
            out[c, :used] = d[k][order[c][:used]]
        batches[k] = out.reshape(C, NB, batch_size, *proto.shape[1:])

    mask = np.zeros((C, NB), bool)
    ex_w = (None if drop_remainder
            else np.zeros((C, NB, batch_size), np.float32))
    for c in range(C):
        mask[c, :n_batches[c]] = True
        if ex_w is not None:
            for j, m in enumerate(step_examples[c]):
                ex_w[c, j, :m] = 1.0
    return PackedEpoch(batches, mask, ex_w, n_batches, step_examples,
                       n_samples, batch_size)


def empty_run(client_data, batch_size: int,
              drop_remainder: bool = True) -> bool:
    """True when no hospital yields a single batch (checked before
    ``pack_run``, so such a run consumes no shuffle yet)."""
    for d in client_data:
        n = len(next(iter(d.values())))
        if _client_batch_count(n, batch_size, drop_remainder)[0]:
            return False
    return True


def pack_run(client_data, batch_size: int, rng, n_epochs: int,
             drop_remainder: bool = True):
    """Pack ``n_epochs`` epochs into ``[n_epochs, C, NB, B, ...]`` numpy
    arrays, consuming ``rng`` exactly as a loop of per-epoch packs would
    (epoch-major, hospital order inside each epoch).  Batch counts, masks
    and weights are the same every epoch (the data sizes do not change);
    the returned ``PackedEpoch`` is the first epoch's."""
    packs = [pack_epoch(client_data, batch_size, rng, drop_remainder)
             for _ in range(n_epochs)]
    batches = {k: np.stack([p.batches[k] for p in packs])
               for k in packs[0].batches}
    return batches, packs[0]


def client_major_log(losses, packed: PackedEpoch):
    """A ``[C, NB]`` loss array flattened in client-major valid order (the
    stepwise FL/centralized order) and the steps' example counts."""
    arr = np.asarray(losses).reshape(len(packed.n_batches), -1)
    flat, weights = [], []
    for c, nb in enumerate(packed.n_batches):
        flat.extend(float(x) for x in arr[c, :nb])
        weights.extend(packed.step_examples[c])
    return flat, weights


def scheduled_log(losses, sched: np.ndarray, packed: PackedEpoch):
    """Per-step losses already in schedule order; the weights follow the
    schedule's (client, batch) rows."""
    flat = [float(x) for x in np.asarray(losses)]
    weights = [packed.step_examples[int(c)][int(b)] for c, b in sched]
    return flat, weights


def layout_key(packed: PackedEpoch, keys) -> tuple:
    """What fixes a program's buffers, step table and constants: the
    hospitals' sample and batch counts, the batch shape and dtypes of
    ``keys`` and whether remainder batches are kept."""
    return (tuple(packed.n_samples), tuple(packed.n_batches),
            packed.batch_size,
            tuple((k, packed.batches[k].shape[3:], str(packed.batches[k]
                                                       .dtype))
                  for k in keys),
            packed.ex_weights is None)


# ---------------------------------------------------------------------------
# capture and replay
# ---------------------------------------------------------------------------

def _clone(tree):
    return tree_map(torch.clone, tree)


def _copy(dst, src):
    tree_map(lambda d, s: d.copy_(s), dst, src)


class Program:
    """Static buffers and named step bodies of one training program.

    A body is a method ``_<name>`` of no arguments that reads the
    program's buffers and writes its results back into them in place
    (``bodies`` names them).  ``program(name)`` runs one step of that
    body: on the card, its captured CUDA graph (the first call warms the
    body up on a side stream, undoes the warm-up's writes to ``carry()``,
    and captures it; a failed capture raises); on the CPU, the body
    itself.  Kernel launch counts (``kernels/build.CudaKernel.launches``)
    follow the device: a capture's counts are taken back, and every replay
    adds the launches its graph holds (``per_replay``).  A program holds
    no reference to its strategy, so dropping the strategy frees the
    graphs' memory pools at once.
    """

    bodies: tuple = ("step",)

    def __init__(self, device: torch.device):
        self.device = device
        self.graphs: dict = {}
        self._launch_deltas: dict = {}  # body -> [(kernel, launches)]
        self._tables: dict = {}         # body -> its graph's GraphTables
        self.t = torch.zeros((1,), dtype=torch.int64, device=device)

    @property
    def captures(self) -> int:
        return len(self.graphs)

    @property
    def per_replay(self) -> dict:
        """body -> {kernel symbol: launches of one replay}."""
        return {name: {k.symbol: n for k, n in deltas}
                for name, deltas in self._launch_deltas.items()}

    def carry(self) -> list:
        """Every buffer a body writes (restored after the warm-up)."""
        raise NotImplementedError

    def __call__(self, name: str) -> None:
        if self.device.type != "cuda":
            getattr(self, "_" + name)()
            return
        graph = self.graphs.get(name)
        if graph is None:
            graph = self._capture(name)
        graph.replay()
        for kernel, n in self._launch_deltas[name]:
            kernel.launches += n

    def _capture(self, name: str):
        body, carry = getattr(self, "_" + name), self.carry()
        saved = [t.clone() for t in carry]
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        tables = B.GraphTables()
        with torch.cuda.stream(side), tables:
            body()
        main.wait_stream(side)
        for t, v in zip(carry, saved):
            t.copy_(v)
        del saved
        kernels = B.CudaKernel.instances
        before = [k.launches for k in kernels]
        # a dead reference cycle that holds another CUDA graph must not be
        # collected, destroying that graph, while this one captures: a
        # graph's destruction is not permitted on a capturing stream and
        # ends the capture with an error
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        graph = torch.cuda.CUDAGraph()
        tables.reserve(self.device)
        try:
            with torch.cuda.graph(graph), tables:
                body()
        finally:
            if collecting:
                gc.enable()
        tables.fill()
        self._tables[name] = tables
        deltas = [(k, k.launches - n) for k, n in zip(kernels, before)
                  if k.launches != n]
        for k, n in zip(kernels, before):
            k.launches = n          # a capture records, it launches nothing
        self._launch_deltas[name] = deltas
        self.graphs[name] = graph
        return graph


class _PackedProgram(Program):
    """A program over one packed epoch layout: the batch buffers (the
    ``[C, NB]`` grid flattened to ``C * NB`` rows), remainder weights, the
    step table (on the device, and its host copy ``rows``), the losses of
    one epoch, the noise buffers of a private step (``draws``) and the
    strategy's step function (``step_fn``)."""

    def __init__(self, strategy, packed: PackedEpoch, table, loss_shape):
        super().__init__(strategy.device)
        self.step_fn = strategy._step
        dev = self.device
        keys = strategy.adapter.batch_keys or tuple(packed.batches)
        self.batches = {
            k: torch.empty((packed.mask.size, packed.batch_size,
                            *packed.batches[k].shape[3:]),
                           dtype=torch.from_numpy(packed.batches[k][:0, :0])
                           .dtype, device=dev)
            for k in keys}
        self.ex_w = (None if packed.ex_weights is None else
                     torch.from_numpy(packed.ex_weights.reshape(
                         -1, packed.batch_size)).to(dev))
        self.rows = np.ascontiguousarray(table, dtype=np.int64)
        self.table = torch.from_numpy(self.rows).to(dev)
        self.n_steps = len(table)
        self.losses = torch.zeros(loss_shape, device=dev)
        self.draws = None

    def batch(self, idx):
        """The batch at flat row ``idx`` (a 1-element device index) and its
        per-example weights (None without remainder batches)."""
        b = {k: v.index_select(0, idx)[0] for k, v in self.batches.items()}
        w = None if self.ex_w is None else self.ex_w.index_select(0, idx)[0]
        return b, w

    def row(self):
        """The step table's row of the current step."""
        return self.table.index_select(0, self.t)[0]

    def fill_draws(self, draws) -> None:
        """Copy one step's noise into the noise buffers: the first step's
        draws become the buffers, which every capture and replay reads."""
        if self.draws is None:
            self.draws = draws
        else:
            _copy(self.draws, draws)

    def run(self, batches: dict, draw=None, key_idx=None, end_round=None):
        """Step every epoch of ``batches`` (``pack_run``'s ``[E, C, NB, B,
        ...]`` arrays).  A keyed program fills its noise buffers with
        ``draw(key_idx[e][s], rows[s])`` before step ``s`` of epoch ``e``,
        ``rows[s]`` the host row of the step table (which names the step's
        hospital: no device read inside the step); a key index of 0 (a
        masked FL cell) draws nothing.  Each epoch ends in the round body,
        if the program has one, then ``end_round()``, if given.  Returns
        the ``[E, *loss_shape]`` device losses."""
        n_epochs = next(iter(batches.values())).shape[0]
        out = torch.empty((n_epochs, *self.losses.shape), device=self.device)
        for e in range(n_epochs):
            for k, buf in self.batches.items():
                buf.copy_(torch.from_numpy(np.ascontiguousarray(
                    batches[k][e].reshape(buf.shape))))
            self.t.zero_()
            for s in range(self.n_steps):
                i = 0 if draw is None else int(key_idx[e][s])
                if i or (draw is not None and self.draws is None):
                    # a masked first cell still makes the buffers
                    self.fill_draws(draw(i, self.rows[s]))
                self("step")
            out[e].copy_(self.losses)
            if "round" in self.bodies:
                self("round")
            if end_round is not None:
                end_round()
        return out


class SeqProgram(_PackedProgram):
    """Centralized: one pooled hospital, persistent params and Adam state
    (``{"params", "opt"}``); one step per batch of the pooled epoch."""

    def __init__(self, strategy, packed: PackedEpoch, state):
        nb = packed.n_batches[0]
        super().__init__(strategy, packed, np.arange(nb)[:, None], (nb,))
        self.params = _clone(state["params"])
        self.opt = _clone(state["opt"])

    def _step(self):
        batch, w = self.batch(self.row()[0:1])
        p, s, loss = self.step_fn(self.params, self.opt, batch, w,
                                  self.draws)
        _copy(self.params, p)
        _copy(self.opt, s)
        self.losses.index_copy_(0, self.t, loss.reshape(1))
        self.t.add_(1)

    def carry(self):
        return [self.t, self.losses,
                *tree_leaves([self.params, self.opt])]

    def load(self, state):
        _copy(self.params, state["params"])
        _copy(self.opt, state["opt"])

    def store(self, state):
        state["params"], state["opt"] = _clone(self.params), _clone(self.opt)


class FLProgram(_PackedProgram):
    """FedAvg: every hospital's local epoch over the ``[C, NB]`` grid,
    client-major.  A hospital's first step starts from the global params
    with a fresh Adam; a masked (padding) step is a no-op; the last params
    of each hospital land in its row of the stacked locals, and the round
    body replaces the global params by their data-size-weighted mean
    (``in_graph_round``; under secure aggregation ``host_round`` does the
    round on the host instead)."""

    bodies = ("step", "round")

    def __init__(self, strategy, packed: PackedEpoch, state,
                 in_graph_round: bool = True):
        C, NB = packed.mask.shape
        rows = [(c * NB + b, c, int(packed.mask[c, b]), int(b == 0))
                for c in range(C) for b in range(NB)]
        super().__init__(strategy, packed, rows, (C * NB,))
        if not in_graph_round:
            self.bodies = ("step",)
        opt = strategy._opt
        self.n_samples = list(packed.n_samples)
        self.glob = _clone(state["params"])
        self.local = _clone(state["params"])
        self.fresh = opt.init(self.glob)
        self.local_opt = opt.init(self.glob)
        self.locals = stack_trees([self.glob] * C)

    def _step(self):
        row = self.row()
        batch, w = self.batch(row[0:1])
        first, valid = row[3].bool(), row[2].bool()
        p_in = tree_select(first, self.glob, self.local)
        s_in = tree_select(first, self.fresh, self.local_opt)
        p, s, loss = self.step_fn(p_in, s_in, batch, w, self.draws)
        p = tree_select(valid, p, p_in)
        _copy(self.local, p)
        _copy(self.local_opt, tree_select(valid, s, s_in))
        tree_put(self.locals, row[1:2], p)
        self.losses.index_copy_(0, self.t, loss.reshape(1))
        self.t.add_(1)

    def _round(self):
        _copy(self.glob, stacked_weighted_mean(self.locals, self.n_samples))

    def host_round(self, aggregate) -> None:
        """The round on the host instead (secure aggregation): the global
        params become ``aggregate(locals, n_samples, prev=glob)`` of the
        hospitals' unstacked locals."""
        locals_ = [tree_map(lambda x, c=c: x[c], self.locals)
                   for c in range(len(self.n_samples))]
        _copy(self.glob, aggregate(locals_, self.n_samples, prev=self.glob))

    def carry(self):
        return [self.t, self.losses, *tree_leaves(
            [self.glob, self.local, self.local_opt, self.locals])]

    def load(self, state):
        _copy(self.glob, state["params"])

    def store(self, state):
        state["params"] = _clone(self.glob)


class InterleavedProgram(_PackedProgram):
    """SL and SFLv2: one sequential server in ``schedule_array`` order.
    Each step gathers the active hospital's client tree and Adam state
    from the stacked buffers by device index, runs the split step (a
    private one with the noise buffers, drawn on the host for the
    hospital of the table's host row) and scatters them back; ``sync``
    adds the SFLv2 round body (every hospital takes the plain mean of the
    client trees)."""

    def __init__(self, strategy, packed: PackedEpoch, state, sched,
                 sync: bool):
        NB = packed.nb_max
        rows = [(int(c) * NB + int(b), int(c)) for c, b in sched]
        super().__init__(strategy, packed, rows, (len(rows),))
        if sync:
            self.bodies = ("step", "round")
        self.clients = stack_trees(state["clients"])
        self.c_opts = stack_trees(state["c_opts"])
        self.server = _clone(state["server"])
        self.s_opt = _clone(state["s_opt"])

    def _step(self):
        row = self.row()
        batch, w = self.batch(row[0:1])
        c = row[1:2]
        cp, sp, co, so, loss = self.step_fn(
            tree_take(self.clients, c), self.server,
            tree_take(self.c_opts, c), self.s_opt, batch, w, self.draws)
        tree_put(self.clients, c, cp)
        tree_put(self.c_opts, c, co)
        _copy(self.server, sp)
        _copy(self.s_opt, so)
        self.losses.index_copy_(0, self.t, loss.reshape(1))
        self.t.add_(1)

    def _round(self):
        _copy(self.clients, stacked_mean_sync(self.clients))

    def carry(self):
        return [self.t, self.losses, *tree_leaves(
            [self.clients, self.c_opts, self.server, self.s_opt])]

    def load(self, state):
        for c, (cp, co) in enumerate(zip(state["clients"],
                                         state["c_opts"])):
            tree_map(lambda x, y, c=c: x[c].copy_(y), self.clients, cp)
            tree_map(lambda x, y, c=c: x[c].copy_(y), self.c_opts, co)
        _copy(self.server, state["server"])
        _copy(self.s_opt, state["s_opt"])

    def store(self, state):
        n = len(state["clients"])
        state["clients"] = [tree_map(lambda x, c=c: x[c].clone(),
                                     self.clients) for c in range(n)]
        state["c_opts"] = [tree_map(lambda x, c=c: x[c].clone(),
                                    self.c_opts) for c in range(n)]
        state["server"], state["s_opt"] = (_clone(self.server),
                                           _clone(self.s_opt))


class SyncProgram(_PackedProgram):
    """SFLv3 and SFLv1: batch-synchronous steps.  Row ``s`` of the table
    holds each hospital's batch of step ``s`` (hospitals short of batches
    wrap around), and the step is ``sflv3_step_fn``'s: every hospital's
    front crosses the cut in one launch per boundary leaf, and a private
    step runs its K4/K5/K6 inside the graph with the noise read from the
    static buffers ``fill_draws`` fills (the first step's draws become
    those buffers).  ``sync`` adds SFLv1's round body."""

    def __init__(self, strategy, packed: PackedEpoch, state, sync: bool):
        C, NB = packed.mask.shape
        steps = packed.nb_max
        rows = [[c * NB + s % packed.n_batches[c] for c in range(C)]
                for s in range(steps)]
        super().__init__(strategy, packed, rows, (steps, C))
        if sync:
            self.bodies = ("step", "round")
        self.n_clients = C
        self.clients = [_clone(cp) for cp in state["clients"]]
        self.c_opts = [_clone(co) for co in state["c_opts"]]
        self.server = _clone(state["server"])
        self.s_opt = _clone(state["s_opt"])

    def _step(self):
        row = self.row()
        batches = [self.batch(row[c:c + 1])[0] for c in range(self.n_clients)]
        clients, server, c_opts, s_opt, losses = self.step_fn(
            self.clients, self.server, self.c_opts, self.s_opt, batches,
            self.draws)
        _copy(self.clients, clients)
        _copy(self.c_opts, c_opts)
        _copy(self.server, server)
        _copy(self.s_opt, s_opt)
        self.losses.index_copy_(0, self.t, losses.reshape(1, -1))
        self.t.add_(1)

    def _round(self):
        avg = tree_mean(self.clients)
        for cp in self.clients:
            _copy(cp, avg)

    def carry(self):
        return [self.t, self.losses, *tree_leaves(
            [self.clients, self.c_opts, self.server, self.s_opt])]

    def load(self, state):
        _copy(self.clients, state["clients"])
        _copy(self.c_opts, state["c_opts"])
        _copy(self.server, state["server"])
        _copy(self.s_opt, state["s_opt"])

    def store(self, state):
        state["clients"] = [_clone(cp) for cp in self.clients]
        state["c_opts"] = [_clone(co) for co in self.c_opts]
        state["server"], state["s_opt"] = (_clone(self.server),
                                           _clone(self.s_opt))


def key_index_grid(strategy, packed: PackedEpoch) -> np.ndarray:
    """``[C, NB]`` step indices of FL's grid in client-major stepwise
    order, reserved from the strategy's running counter for the real cells
    only; a masked cell keeps 0 and draws nothing."""
    grid = np.zeros((len(packed.n_batches), packed.nb_max), np.int64)
    if strategy._keyed:
        for c, nb in enumerate(packed.n_batches):
            grid[c, :nb] = strategy._take_key_indices(nb)
    return grid


def program_for(strategy, kind, packed: PackedEpoch, build):
    """The strategy's program of this packed layout, built by ``build()``
    the first time (one capture per program, none per epoch or run)."""
    keys = strategy.adapter.batch_keys or tuple(packed.batches)
    key = (kind, layout_key(packed, keys))
    prog = strategy._programs.get(key)
    if prog is None:
        prog = strategy._programs[key] = build()
    return prog


__all__ = ["PackedEpoch", "pack_epoch", "pack_run", "empty_run",
           "client_major_log", "scheduled_log", "key_index_grid",
           "Program", "SeqProgram",
           "FLProgram", "InterleavedProgram", "SyncProgram", "program_for"]
