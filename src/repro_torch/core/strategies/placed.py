"""Placed runs: the hospital axis of a compiled run split over devices
(``core.placement``), the port of the reference's ``shard_map`` programs.

``make_strategy(..., shard=True)`` gives a strategy a ``Placement``.  When
it is enabled (two devices or more) or padded (phantom hospitals forced
in), the strategy's ``_run_compiled`` packs the run as before and hands
the packed arrays here.  Each chunk of hospitals (``Placement.chunks``:
contiguous, one per device, named by its index, so ``[cuda:0] * 4`` is
four chunks) gets its own programs of ``engine.py``: its hospitals' batch
stacks, step table rows, client params and optimizer states, and its own
captured graphs, all on its device, in its own ``GraphPool``.  Phantom
hospitals pad the axis to a device multiple: all-zero batches,
all-invalid masks, and zero weight in every reduction.

What crosses chunks happens between replays, on the host's order:
  * FedAvg's round: every chunk's locals of its REAL hospitals are
    gathered onto the first chunk's device in hospital order, the
    strategy's ``core.aggregate`` rule reduces them there (phantoms carry
    no weight: they are left out), and the new global params are copied
    back to every chunk;
  * SL/SFLv2's sequential server: the server params and Adam state move
    to the chunk of the next step's hospital whenever it changes (the
    cut-layer crossings stay inside a chunk, so ``Transport``'s bytes are
    the unplaced run's); SFLv2's client sync is the plain mean of the real
    hospitals' client trees, gathered in hospital order and copied back;
  * SFLv3/v1's server (``sflv3_step_fn(phases=True)``): ONE server on
    the first device runs the middle over every real hospital's rows in
    hospital order, as the unplaced step's joint pass does; each step
    the chunks' link outputs cross to it and the gradient at the cut
    crosses back (under NLS the middle's output and its gradient too),
    and each chunk backpropagates its fronts (``ClientChunk``,
    ``ServerChunk``).  A private step differentiates each hospital's
    whole model, so each chunk holds a replica of the server and the
    hospitals' server gradients are gathered in hospital order and
    summed (``ReplicaChunk``).  SFLv1's client sync is SFLv2's.

Every placed run computes what the unplaced run computes, in the same
order, so it is bit-equal to it (the reference's bar is 1e-5).  The noise
of a private step is drawn per chunk on its device, for the hospitals it
holds, keyed on their global ids; phantoms draw for their own ids, so no
real hospital's draws change.  Each run function returns
the losses and metrics in the unplaced program's layout (``[E, ...]``
numpy, real hospitals only), so the strategy's logs, telemetry, wire and
privacy accounting are shared with the unplaced path.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.aggregate import stacked_mean_sync, tree_mean
from repro_torch.core.strategies import engine as ENG
from repro_torch.obs.telemetry import update_cosine
from repro_torch.tree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# chunks of the packed run
# ---------------------------------------------------------------------------

def padded_epoch(packed: ENG.PackedEpoch, place) -> ENG.PackedEpoch:
    """A real-hospital ``PackedEpoch`` with ``place.n_pad`` phantom
    hospitals appended (``pack_epoch(pad_clients=)``'s layout)."""
    pad = place.n_pad
    return ENG.PackedEpoch(
        {k: place.pad_rows(v) for k, v in packed.batches.items()},
        place.pad_rows(packed.mask),
        None if packed.ex_weights is None
        else place.pad_rows(packed.ex_weights),
        list(packed.n_batches) + [0] * pad,
        list(packed.step_examples) + [[] for _ in range(pad)],
        list(packed.n_samples) + [0] * pad, packed.batch_size)


def chunk_epoch(packed: ENG.PackedEpoch, chunk) -> ENG.PackedEpoch:
    """The rows of ``chunk``'s hospitals of a padded ``PackedEpoch``."""
    sl = slice(chunk.ids[0], chunk.ids[-1] + 1)
    return ENG.PackedEpoch(
        {k: v[sl] for k, v in packed.batches.items()}, packed.mask[sl],
        None if packed.ex_weights is None else packed.ex_weights[sl],
        packed.n_batches[sl], packed.step_examples[sl],
        packed.n_samples[sl], packed.batch_size)


def chunk_state(state: dict, chunk, n_clients: int) -> dict:
    """A split-family state restricted to ``chunk``'s hospitals: a phantom
    takes the last real hospital's client tree and optimizer state
    (``Placement.pad_tree``'s edge mode: its forward stays finite)."""
    rows = [min(g, n_clients - 1) for g in chunk.ids]
    return {"clients": [state["clients"][g] for g in rows],
            "c_opts": [state["c_opts"][g] for g in rows],
            "server": state["server"], "s_opt": state["s_opt"]}


def load_batches(prog, batches: dict, e: int, chunk) -> None:
    """Copy epoch ``e`` of ``chunk``'s hospitals (padded ``[E, c_pad, NB,
    B, ...]`` host arrays) into its program's batch buffers."""
    sl = slice(chunk.ids[0], chunk.ids[-1] + 1)
    for k, buf in prog.batches.items():
        buf.copy_(torch.from_numpy(np.ascontiguousarray(
            batches[k][e, sl].reshape(buf.shape))))


def _real_rows(chunks, n_clients: int, stacked_of):
    """The real hospitals' rows of every chunk's stacked tree
    (``stacked_of(k)``: chunk ``k``'s), gathered in hospital order onto
    the first chunk's device."""
    dev = chunks[0].device
    parts = []
    for ch in chunks:
        n = sum(1 for g in ch.ids if g < n_clients)
        if n:
            parts.append(tree_map(lambda x, n=n: x[:n].to(dev),
                                  stacked_of(ch.index)))
    return tree_map(lambda *xs: torch.cat(xs), *parts)


def _set_rows(stacked, value) -> None:
    """Every row of a stacked tree becomes ``value`` (a tree of one row,
    or of rows that broadcast), on the stacked tree's device."""
    tree_map(lambda x, v: x.copy_(v.to(x.device).expand_as(x)), stacked,
             value)


def _host(tensors: list) -> list:
    """Device tensors -> numpy, one copy per device tensor."""
    return [t.cpu().numpy() for t in tensors]


def _programs(strat, kind, chunks, packed, build):
    """One program per chunk (``engine.program_for``, keyed on the chunk's
    index and layout), built by ``build(chunk, sub_packed, telemetry)``."""
    out = []
    for ch in chunks:
        sub = chunk_epoch(packed, ch)
        out.append(ENG.program_for(
            strat, (kind, ch.index), sub,
            lambda t, ch=ch, sub=sub: build(ch, sub, t)))
    return out


# ---------------------------------------------------------------------------
# FedAvg
# ---------------------------------------------------------------------------

def run_fl(strat, state, batches: dict, pack, key_idx: np.ndarray):
    """FedAvg's whole run over the placement.  ``batches`` and ``pack`` are
    ``pack_participation_run``'s with every hospital sampled, ``key_idx``
    the ``[E, N, NB]`` step indices of the unplaced run.  Returns the
    ``[E, N * NB]`` losses and ``{key: [E, ...]}`` metrics (numpy)."""
    place, tel, agg = strat.placement, strat._tel, strat._agg
    N, E = pack.n_global, key_idx.shape[0]
    chunks = place.chunks(strat.device)
    padded = {k: place.pad_rows(v, axis=1) for k, v in batches.items()}
    first = padded_epoch(pack.epoch(0, batches), place)
    keys = place.pad_rows(key_idx, axis=1)
    progs = _programs(strat, "fl_placed", chunks, first,
                      lambda ch, sub, t: ENG.FLProgram(
                          strat, sub, state, False, t, gids=ch.ids,
                          chunk=ch))
    draws = []
    for ch, prog in zip(chunks, progs):
        prog.load(state)
        draws.append(strat._program_draw(chunk_epoch(first, ch), prog.glob,
                                         device=ch.device))
    dev0 = chunks[0].device
    agg_w = torch.tensor(pack.agg_w[0], dtype=torch.float32, device=dev0)
    stale = torch.zeros((N,), device=dev0)
    gids = torch.arange(N, dtype=torch.int64, device=dev0)
    losses = [torch.empty((E, *p.losses.shape), device=p.device)
              for p in progs]
    mets = [{k: torch.empty((E, *v.shape), device=p.device)
             for k, v in p.metrics.items()} for p in progs]
    cos = torch.empty((E, N), device=dev0)
    observe_cos = tel is not None and tel.update_cosine
    calls = [dict(p.calls) for p in progs]
    with strat._dispatching(progs):
        for e in range(E):
            with strat._span("h2d"):
                for ch, prog in zip(chunks, progs):
                    load_batches(prog, padded, e, ch)
                    prog.t.zero_()
            for s in range(progs[0].n_steps):
                for ch, prog, draw in zip(chunks, progs, draws):
                    i = 0 if draw is None else int(
                        keys[e, ch.ids[0]:ch.ids[-1] + 1].reshape(-1)[s])
                    if i or (draw is not None and prog.draws is None):
                        prog.fill_draws(draw(i, prog.rows[s]))
                    prog("step")
            for k, prog in enumerate(progs):
                losses[k][e].copy_(prog.losses)
                for key, v in prog.metrics.items():
                    mets[k][key][e].copy_(v)
            # the round: the real hospitals' locals, gathered in order
            locals_ = _real_rows(chunks, N, lambda k: progs[k].locals)
            old = progs[0].glob
            if agg.scan_compatible:
                new = agg.aggregate(locals_, agg_w, old, stale, gids)
            else:
                new = agg.aggregate_trees(
                    [tree_map(lambda x, c=c: x[c], locals_)
                     for c in range(N)], list(pack.agg_w[0]), prev=old)
            if observe_cos:
                cos[e].copy_(update_cosine(locals_, old, new))
            for prog in progs:
                ENG._copy(prog.glob, new)
    strat._dispatch( progs, calls, 1)
    state["params"] = ENG._clone(progs[0].glob, strat.device)
    out = _gather_columns(chunks, N, _host(losses), pack.nb_max)
    met = {key: _gather_columns(chunks, N, _host([m[key] for m in mets]),
                                pack.nb_max) for key in mets[0]}
    if observe_cos:
        met["update_cosine"] = cos.cpu().numpy()
    return out, met


def _gather_columns(chunks, n_clients: int, arrays: list, width: int):
    """Per-chunk ``[E, c_k * width]`` arrays (slot-major) -> ``[E, N *
    width]``, the real hospitals' columns in hospital order."""
    cols = []
    for ch, a in zip(chunks, arrays):
        a = a.reshape(a.shape[0], len(ch.ids), width)
        cols += [a[:, j] for j, g in enumerate(ch.ids) if g < n_clients]
    return np.stack(cols, axis=1).reshape(arrays[0].shape[0], -1)


# ---------------------------------------------------------------------------
# SL and SFLv2: the sequential server
# ---------------------------------------------------------------------------

def run_interleaved(strat, state, batches: dict, pack, key_idx, sched,
                    sync: bool):
    """SL/SFLv2's whole run over the placement: the schedule ``sched``
    (``(hospital, batch)`` pairs of one epoch) steps each hospital in its
    chunk's program; the server moves between chunks with the schedule.
    Returns the ``[E, len(sched)]`` losses and metrics (numpy)."""
    place, N = strat.placement, pack.n_global
    E = key_idx.shape[0]
    chunks = place.chunks(strat.device)
    size = len(chunks[0].ids)
    padded = {k: place.pad_rows(v, axis=1) for k, v in batches.items()}
    first = padded_epoch(pack.epoch(0, batches), place)
    owner = [int(c) // size for c, _b in sched]
    local = [[] for _ in chunks]     # per chunk: its steps' (slot, batch)
    pos = []                         # per global step: its chunk's index
    for (c, b), k in zip(sched, owner):
        pos.append(len(local[k]))
        local[k].append((int(c) - k * size, int(b)))
    progs = _programs(
        strat, "interleaved_placed", chunks, first,
        lambda ch, sub, t: ENG.InterleavedProgram(
            strat, sub, chunk_state(state, ch, N),
            max(len(local[ch.index]), 1), False, t, chunk=ch))
    draws = []
    for ch, prog in zip(chunks, progs):
        prog.load(chunk_state(state, ch, N))
        prog.load_round(ENG.interleaved_rows(local[ch.index], pack.nb_max,
                                             ch.ids, range(size)))
        draws.append(strat._program_draw(
            chunk_epoch(first, ch), {"c": state["clients"][0],
                                     "s": state["server"]},
            device=ch.device))
    losses = [torch.empty((E, *p.losses.shape), device=p.device)
              for p in progs]
    mets = [{k: torch.empty((E, *v.shape), device=p.device)
             for k, v in p.metrics.items()} for p in progs]
    calls = [dict(p.calls) for p in progs]
    holder = None                    # the chunk holding the newest server
    with strat._dispatching(progs):
        for e in range(E):
            with strat._span("h2d"):
                for ch, prog in zip(chunks, progs):
                    load_batches(prog, padded, e, ch)
                    prog.t.zero_()
            for p, k in enumerate(owner):
                prog = progs[k]
                if holder is not None and holder != k:
                    ENG._copy(prog.server, progs[holder].server)
                    ENG._copy(prog.s_opt, progs[holder].s_opt)
                holder = k
                draw = draws[k]
                i = 0 if draw is None else int(key_idx[e, p])
                if i:
                    prog.fill_draws(draw(i, prog.rows[pos[p]]))
                prog("step")
            for k, prog in enumerate(progs):
                losses[k][e].copy_(prog.losses)
                for key, v in prog.metrics.items():
                    mets[k][key][e].copy_(v)
            if sync:
                mean = stacked_mean_sync(_real_rows(
                    chunks, N, lambda k: progs[k].clients))
                for prog in progs:
                    _set_rows(prog.clients, tree_map(lambda m: m[0], mean))
    strat._dispatch( progs, calls, 1)
    _store_split(state, chunks, progs, N, progs[holder or 0])
    return (_schedule_order(_host(losses), owner, pos),
            {key: _schedule_order(_host([m[key] for m in mets]), owner, pos)
             for key in mets[0]})


def _schedule_order(arrays: list, owner, pos) -> np.ndarray:
    """Per-chunk ``[E, steps_k]`` arrays -> ``[E, steps]`` in schedule
    order."""
    return np.stack([arrays[k][:, j] for k, j in zip(owner, pos)], axis=1)


def _store_split(state, chunks, progs, n_clients: int, server_prog,
                 stacked=("clients", "c_opts")) -> None:
    """Write every chunk's real hospitals back into ``state`` (on the
    state's device) and the server from ``server_prog``."""
    dev = tree_leaves(state["server"])[0].device
    names = {"clients": stacked[0], "c_opts": stacked[1]}
    for ch, prog in zip(chunks, progs):
        for j, g in enumerate(ch.ids):
            if g >= n_clients:
                continue
            for key, attr in names.items():
                state[key][g] = tree_map(lambda x, j=j: x[j].to(dev,
                                                                copy=True),
                                         getattr(prog, attr))
    state["server"] = ENG._clone(server_prog.server, dev)
    state["s_opt"] = ENG._clone(server_prog.s_opt, dev)


# ---------------------------------------------------------------------------
# SFLv3 and SFLv1: the batch-synchronous server
# ---------------------------------------------------------------------------

def boundary_buffers(strat, packed, rows: int, device) -> list:
    """Zero trees of each crossing's shapes (front->middle, and
    middle->tail under NLS), ``rows`` examples long, on ``device``."""
    from repro_torch.core.partition import as_meta
    example = {k: as_meta(torch.from_numpy(v[0, 0]))
               for k, v in packed.batches.items()}
    specs = strat.adapter.boundary_specs(example).values()
    return [tree_map(lambda m: torch.zeros((rows, *m.shape[1:]),
                                           dtype=m.dtype, device=device),
                     spec) for spec in specs]


def _rows(tree, start: int, n: int):
    return tree_map(lambda x: x[start:start + n], tree)


class ClientChunk(ENG.SyncProgram):
    """One chunk of a placed non-private SFLv3/v1 run: its hospitals'
    client segments (``SyncProgram``'s buffers; every hospital of the
    chunk a slot, ``slot_gid`` its own rows) on the chunk's device, the
    step cut at the link (``sflv3_step_fn(phases=True)``): ``front`` writes
    the link's output ``h``; under NLS ``tail`` reads the middle's output
    ``o`` and writes its gradient ``do``, the tails' gradients and the
    losses; ``back`` reads ``dh`` and the server's squared norms
    ``sq_server``, updates the clients and records the taps."""

    def __init__(self, strategy, packed, state, capacity: int,
                 telemetry=None, chunk=None):
        super().__init__(strategy, packed, state, False, capacity,
                         telemetry, chunk=chunk)
        self.bodies = (("begin", "front", "tail", "back", "round")
                       if strategy.adapter.nls else
                       ("begin", "front", "back", "round"))
        self.fns = strategy._phases(telemetry)
        rows = self.n_slots * packed.batch_size
        bufs = boundary_buffers(strategy, packed, rows, self.device)
        self.h, self.dh = bufs[0], tree_map(torch.zeros_like, bufs[0])
        self.o = self.do = self.tail_g = None
        if strategy.adapter.nls:
            self.o, self.do = bufs[1], tree_map(torch.zeros_like, bufs[1])
            self.tail_g = [tree_map(torch.zeros_like, cp["tail"])
                           for cp in self.clients]
        self.sq_server = torch.zeros((2,), device=self.device)
        self.cut = {k: torch.zeros((self.n_slots,), device=self.device)
                    for k in self.metrics if k.startswith("cut_")}

    def batches_now(self):
        row = self.row()
        return [self.batch(row[c:c + 1])[0] for c in range(self.n_slots)]

    def _front(self):
        h, met = self.fns.front(self.clients, self.batches_now(), self.draws)
        ENG._copy(self.h, h)
        for k, v in met.items():
            self.cut[k].copy_(v)

    def _tail(self):
        gts, do, losses = self.fns.tail(self.clients, self.o,
                                        self.batches_now(), self.draws)
        ENG._copy(self.tail_g, gts)
        ENG._copy(self.do, do)
        self.losses.index_copy_(0, self.t, losses.reshape(1, -1))

    def _back(self):
        clients, c_opts, met = self.fns.back(
            self.clients, self.c_opts, self.batches_now(), self.draws,
            self.dh, self.tail_g, self.sq_server)
        ENG._copy(self.clients, clients)
        ENG._copy(self.c_opts, c_opts)
        for k, v in {**self.cut, **met}.items():
            self.metrics[k].index_copy_(0, self.t, v.reshape(1, -1))
        self.t.add_(1)

    def carry(self):
        return super().carry() + tree_leaves(
            [self.h, self.o, self.do, self.tail_g, self.cut])


class ServerChunk(ENG._PackedProgram):
    """The one server of a placed non-private SFLv3/v1 run, on the first
    chunk's device: the real hospitals' batches (their labels for the
    loss), the step table, the server params and Adam state, the link's
    output of every real hospital ``h`` in hospital order (copied in from
    the chunks) and the gradient ``dh`` it returns.  LS: one ``server``
    body (the middle, the loss, the update; it records the losses); NLS:
    ``fwd`` writes the middle's output ``o``, ``bwd`` reads its gradient
    ``do`` and updates.  ``sq`` holds the server's squared gradient and
    update norms for the chunks' taps."""

    def __init__(self, strategy, packed, state, capacity: int,
                 telemetry=None, chunk=None):
        N = packed.mask.shape[0]
        super().__init__(strategy, packed, np.zeros((capacity, N)),
                         (capacity, N), None, N, chunk=chunk)
        self.bodies = (("fwd", "bwd") if strategy.adapter.nls
                       else ("server",))
        self.fns = strategy._phases(telemetry)
        self.n = N
        dev = self.device
        self.server = ENG._clone(state["server"], dev)
        self.s_opt = ENG._clone(state["s_opt"], dev)
        bufs = boundary_buffers(strategy, packed, N * packed.batch_size,
                                dev)
        self.h, self.dh = bufs[0], tree_map(torch.zeros_like, bufs[0])
        self.o = self.do = None
        if strategy.adapter.nls:
            self.o, self.do = bufs[1], tree_map(torch.zeros_like, bufs[1])
        self.sq = torch.zeros((2,), device=dev)

    def batches_now(self):
        row = self.row()
        return [self.batch(row[c:c + 1])[0] for c in range(self.n)]

    def _finish(self, server, s_opt, dh, sq):
        ENG._copy(self.server, server)
        ENG._copy(self.s_opt, s_opt)
        ENG._copy(self.dh, dh)
        if sq is not None:
            self.sq.copy_(sq)
        self.t.add_(1)

    def _server(self):
        server, s_opt, dh, losses, sq = self.fns.server(
            self.server, self.s_opt, self.h, self.batches_now())
        self.losses.index_copy_(0, self.t, losses.reshape(1, -1))
        self._finish(server, s_opt, dh, sq)

    def _fwd(self):
        ENG._copy(self.o, self.fns.server_fwd(self.server, self.h,
                                              self.batches_now()))

    def _bwd(self):
        self._finish(*self.fns.server_bwd(self.server, self.s_opt, self.h,
                                          self.do, self.batches_now()))

    def carry(self):
        return [self.t, self.losses, self.sq, *tree_leaves(
            [self.server, self.s_opt, self.h, self.dh, self.o, self.do])]

    def load(self, state):
        ENG._copy(self.server, state["server"])
        ENG._copy(self.s_opt, state["s_opt"])


class ReplicaChunk(ENG.SyncProgram):
    """One chunk of a placed private SFLv3/v1 run: ``SyncProgram``'s
    buffers with a replica of the server, the step in two bodies around
    the gather of the server gradient: ``grad`` updates the chunk's
    clients and writes each hospital's server gradient into its row of
    ``gss`` (flat); ``update`` applies the mean in ``gs`` (flat, the
    run's ``server_mean`` of every real hospital's row) to the replica
    and records the step.  The per-hospital halves of the norm taps cross
    between the bodies in ``parts``."""

    bodies = ("begin", "grad", "update", "round")

    def __init__(self, strategy, packed, state, capacity: int,
                 telemetry=None, chunk=None):
        super().__init__(strategy, packed, state, False, capacity,
                         telemetry, chunk=chunk)
        self.fns = strategy._phases(telemetry)
        leaves = tree_leaves(self.server)
        if len({l.dtype for l in leaves}) != 1:
            raise ValueError("a placed private SFLv3 step needs server "
                             "leaves of one dtype")
        sizes = [l.numel() for l in leaves]
        self.gss = torch.zeros((self.n_slots, sum(sizes)),
                               dtype=leaves[0].dtype, device=self.device)
        self.gs_flat = torch.zeros_like(self.gss[0])
        views = iter(self.gs_flat.split(sizes))
        self.gs = tree_map(lambda l: next(views).view(l.shape), self.server)
        self.parts = {k: torch.zeros((self.n_slots,), device=self.device)
                      for k in self.metrics if k not in ("grad_norm",
                                                         "update_norm")}
        if "grad_norm" in self.metrics:
            self.parts.update(
                sq_grad=torch.zeros((self.n_slots,), device=self.device),
                sq_update=torch.zeros((self.n_slots,), device=self.device))

    def _grad(self):
        row = self.row()
        batches = [self.batch(row[c:c + 1])[0] for c in range(self.n_slots)]
        clients, c_opts, gss, losses, parts = self.fns.grads(
            self.clients, self.server, self.c_opts, batches, self.draws)
        ENG._copy(self.clients, clients)
        ENG._copy(self.c_opts, c_opts)
        for j, g in enumerate(gss):
            torch.cat([l.reshape(-1) for l in tree_leaves(g)],
                      out=self.gss[j])
        self.losses.index_copy_(0, self.t, losses.reshape(1, -1))
        for k, v in parts.items():
            self.parts[k].copy_(v)

    def _update(self):
        server, s_opt, met = self.fns.server_step(self.server, self.s_opt,
                                                  self.gs, self.parts)
        ENG._copy(self.server, server)
        ENG._copy(self.s_opt, s_opt)
        for k, v in met.items():
            self.metrics[k].index_copy_(0, self.t, v.reshape(1, -1))
        self.t.add_(1)

    def carry(self):
        return super().carry() + [self.gss, self.gs_flat,
                                  *self.parts.values()]


def run_sync(strat, state, batches: dict, pack, key_idx, steps: int,
             sync: bool):
    """SFLv3/v1's whole run over the placement, ``steps`` synchronous
    steps an epoch: the clients in their chunks, the server on the first
    device (private: a replica in each chunk).  Returns the ``[E, steps,
    N]`` losses and metrics (numpy)."""
    place, N = strat.placement, pack.n_global
    E = key_idx.shape[0]
    chunks = place.chunks(strat.device)
    padded = {k: place.pad_rows(v, axis=1) for k, v in batches.items()}
    real = pack.epoch(0, batches)
    first = padded_epoch(real, place)
    dp = strat._dp
    kind = ReplicaChunk if dp else ClientChunk
    progs = _programs(strat, "sync_placed", chunks, first,
                      lambda ch, sub, t: kind(strat, sub, chunk_state(
                          state, ch, N), steps, t, chunk=ch))
    server = None
    if not dp:
        from repro_torch.core.placement import Chunk
        head = Chunk("server", chunks[0].device, tuple(range(N)))
        server = ENG.program_for(strat, ("sync_server", 0), real,
                                 lambda t: ServerChunk(strat, real, state,
                                                       steps, t, head))
        server.load(state)
        server.load_round(ENG.sync_rows(real.n_batches, pack.nb_max, steps))
    example = {k: v[0, 0] for k, v in first.batches.items()}
    for ch, prog in zip(chunks, progs):
        prog.load(chunk_state(state, ch, N))
        prog.load_round(ENG.sync_rows(chunk_epoch(first, ch).n_batches,
                                      pack.nb_max, steps),
                        slot_gid=np.arange(len(ch.ids)))
    # every real hospital's (chunk, row) in hospital order
    where = [(k, j) for k, ch in enumerate(chunks)
             for j, g in enumerate(ch.ids) if g < N]
    losses = [torch.empty((E, *p.losses.shape), device=p.device)
              for p in progs]
    mets = [{k: torch.empty((E, *v.shape), device=p.device)
             for k, v in p.metrics.items()} for p in progs]
    s_losses = None if server is None else torch.empty(
        (E, *server.losses.shape), device=server.device)
    everyone = progs + ([server] if server is not None else [])
    calls = [dict(p.calls) for p in everyone]
    with strat._dispatching(everyone):
        for e in range(E):
            with strat._span("h2d"):
                for ch, prog in zip(chunks, progs):
                    load_batches(prog, padded, e, ch)
                if server is not None:
                    load_batches(server, padded, e, head)
            for prog in progs:
                prog.t.zero_()
                prog("begin")
            if server is not None:
                server.t.zero_()
            for s in range(steps):
                i = int(key_idx[e, s])
                for ch, prog in zip(chunks, progs):
                    if strat._keyed and (i or prog.draws is None):
                        prog.fill_draws(strat._step_draws(
                            i, prog.clients, prog.server, example, ch.ids,
                            device=ch.device))
                if dp:
                    _dp_step(progs, where, N, chunks[0].device)
                else:
                    _split_step(strat, progs, server, where,
                                pack.batch_size)
            for k, prog in enumerate(progs):
                losses[k][e].copy_(prog.losses)
                for key, v in prog.metrics.items():
                    mets[k][key][e].copy_(v)
                prog("round")
            if server is not None:
                s_losses[e].copy_(server.losses)
            if sync:
                rows = _real_rows(chunks, N, lambda k: progs[k].all_clients)
                mean = tree_mean([tree_map(lambda x, c=c: x[c], rows)
                                  for c in range(N)])
                for prog in progs:
                    _set_rows(prog.all_clients, mean)
    strat._dispatch(everyone, calls, N)
    _store_split(state, chunks, progs, N, progs[0] if dp else server,
                 ("all_clients", "all_c_opts"))
    for co in state["c_opts"]:
        ENG._copy_counts(co, progs[0].count)
    out = (s_losses.cpu().numpy()
           if server is not None and not strat.adapter.nls
           else _sync_columns(chunks, N, _host(losses)))
    return out, {key: _sync_columns(chunks, N, _host([m[key] for m in mets]))
                 for key in mets[0]}


def _split_step(strat, progs, server, where, B: int) -> None:
    """One non-private step: the chunks' fronts, the link's output to the
    server in hospital order, the server (under NLS its output back to the
    chunks' tails and their gradient to the server), the gradient ``dh``
    and the server's norms back to the chunks, their backward."""
    for prog in progs:
        prog("front")
    for g, (k, j) in enumerate(where):
        ENG._copy(_rows(server.h, g * B, B), _rows(progs[k].h, j * B, B))
    if strat.adapter.nls:
        server("fwd")
        for g, (k, j) in enumerate(where):
            ENG._copy(_rows(progs[k].o, j * B, B), _rows(server.o, g * B, B))
        for prog in progs:
            prog("tail")
        for g, (k, j) in enumerate(where):
            ENG._copy(_rows(server.do, g * B, B),
                       _rows(progs[k].do, j * B, B))
        server("bwd")
    else:
        server("server")
    for g, (k, j) in enumerate(where):
        ENG._copy(_rows(progs[k].dh, j * B, B), _rows(server.dh, g * B, B))
    for prog in progs:
        prog.sq_server.copy_(server.sq)
        prog("back")


def _dp_step(progs, where, n_clients: int, dev0) -> None:
    """One private step: the chunks' ``grad`` bodies, ``server_mean`` of
    every real hospital's server gradient in hospital order on the first
    device, copied back to every chunk, their ``update`` bodies."""
    for prog in progs:
        prog("grad")
    total = None
    for k, j in where:
        row = progs[k].gss[j].to(dev0)
        total = row if total is None else total + row
    total = total / n_clients
    for prog in progs:
        prog.gs_flat.copy_(total)
        prog("update")


def _sync_columns(chunks, n_clients: int, arrays: list) -> np.ndarray:
    """Per-chunk ``[E, steps, c_k]`` arrays -> ``[E, steps, N]``, the real
    hospitals' columns in hospital order."""
    cols = [a[:, :, j] for ch, a in zip(chunks, arrays)
            for j, g in enumerate(ch.ids) if g < n_clients]
    return np.stack(cols, axis=2)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def scores_all(strat, state, datas: list, batch_size, chunk_batches):
    """Every hospital's scores, each on its own chunk's device (phantoms
    have no data: nothing to slice off)."""
    from repro_torch.core.partition import grid_scores
    place = strat.placement
    out = []
    for i, d in enumerate(datas):
        dev = place.device_of(i) or strat.device
        params = tree_map(lambda t: t.to(dev),
                          strat.params_for_eval(state, i))
        out.append(grid_scores(strat.adapter, params, d, batch_size,
                               chunk_batches))
    return out


__all__ = ["run_fl", "run_interleaved", "run_sync", "scores_all",
           "ClientChunk", "ServerChunk", "ReplicaChunk", "padded_epoch",
           "chunk_epoch",
           "chunk_state"]
