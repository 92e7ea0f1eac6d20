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
    its real cells only; a masked cell draws nothing;
  * **round boundaries** (the FedAvg round through the strategy's
    ``core.aggregate.Aggregator``, the SFLv2/v1 client sync) are a second
    captured body, replayed once an epoch; a rule that is not
    ``scan_compatible`` (secure aggregation, a host-side protocol) runs on
    the host instead (``_PackedProgram.run``'s ``end_round``);
  * **participation** (``core.participation``): the FL and split-family
    programs step rounds, each round's sampled hospitals packed into a
    fixed slot axis (``pack_participation_run``, the reference's packing
    and rng draws); without ``participation=`` every hospital is sampled
    every round (``Participation(k=N)``).  Who takes part is per-round
    DATA: before each round the program copies the round's step table
    (and its host copy), remainder weights, aggregation weights, staleness
    and slot -> global id map into static buffers (``load_round``), so one
    capture of each body serves every round.  The table holds the round's
    own steps, never more than its buffer (sized by the layout: the
    full-N schedule or ``NB_N``) and the replay loop runs just those; the
    hospital column holds the GLOBAL id, which the noise draws read;
  * **analytic accounting**: wire bytes and epsilon of a whole run are
    composed on the host from shapes and counts (``Transport.account(
    count=)``, ``Strategy._dp_account(count=)``);
  * **telemetry** (``obs.telemetry``): an observed run steps its own
    program (cached apart, keyed on the spec), whose step function writes
    each step's metric taps into device buffers beside the losses and
    whose FL round writes the update cosine; they come back with the
    losses.  A strategy's programs warm up and capture in one
    ``GraphPool``.
  * **tracing** (``obs.trace``): while a traced run dispatches
    (``Strategy._dispatching``) a program times each replay on the card
    with a pair of CUDA events from its pool (``Program.tracer``), and
    places them on the tracer's device lane after the run's readback.

A whole ``Strategy.run(n_epochs)`` packs every round up front, then for
each round copies its batches and step table into the static buffers and
replays; the losses (and metrics) of the run come back in one copy at
its end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import numpy as np
import torch

from repro_torch.core.aggregate import stacked_mean_sync, tree_mean
from repro_torch.kernels import build as B
from repro_torch.obs.telemetry import update_cosine
from repro_torch.obs.trace import TID_DEVICE
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

    @property
    def total_steps(self) -> int:
        return int(sum(self.n_batches))

    @property
    def shapes(self) -> tuple:
        """(key, per-example shape, dtype) of every batch array."""
        return tuple((k, tuple(v.shape[3:]), str(v.dtype))
                     for k, v in self.batches.items())


def _client_batch_count(n: int, batch_size: int,
                        drop_remainder: bool) -> tuple[int, int, int]:
    """``(nb, nb_full, rem)`` for one hospital of ``n`` samples — the
    batching rule of ``np_batches``, shared by ``pack_epoch`` and
    ``empty_run``."""
    nb_full, rem = divmod(n, batch_size)
    return nb_full + (1 if rem and not drop_remainder else 0), nb_full, rem


def pack_epoch(client_data: list, batch_size: int,
               rng: np.random.Generator | None,
               drop_remainder: bool = True,
               pad_clients: int = 0) -> PackedEpoch:
    """Shuffle + pack every hospital's epoch (mirrors ``np_batches``): the
    shuffles consume ``rng`` in hospital order, exactly the draws the
    stepwise engine makes, so both engines train on the same batches.

    ``pad_clients`` appends that many *phantom hospitals* (zero samples,
    all-zero batches, all-invalid masks) to reach a device multiple for
    ``core.placement``; the real rows come from the same rng stream."""
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
    n_batches += [0] * pad_clients
    n_samples += [0] * pad_clients
    step_examples += [[] for _ in range(pad_clients)]
    NB = max(n_batches, default=0)
    C = len(client_data) + pad_clients

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
             drop_remainder: bool = True, pad_clients: int = 0):
    """Pack ``n_epochs`` epochs into ``[n_epochs, C, NB, B, ...]`` numpy
    arrays, consuming ``rng`` exactly as a loop of per-epoch packs would
    (epoch-major, hospital order inside each epoch).  Batch counts, masks
    and weights are the same every epoch (the data sizes do not change);
    the returned ``PackedEpoch`` is the first epoch's.  ``pad_clients``
    phantom hospitals (``pack_epoch``) ride along every epoch."""
    packs = [pack_epoch(client_data, batch_size, rng, drop_remainder,
                        pad_clients) for _ in range(n_epochs)]
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


def layout_key(packed, keys) -> tuple:
    """What fixes a program's buffers, step table and constants: the
    hospitals' sample and batch counts, the batch shape and dtypes of
    ``keys``, whether remainder batches are kept and, for a
    ``ParticipationPack`` (counts per global hospital), the slot count:
    never the sampled ids, so captures do not grow with the rounds."""
    return (tuple(packed.n_samples), tuple(packed.n_batches),
            packed.batch_size,
            tuple(s for s in packed.shapes if s[0] in keys),
            packed.ex_weights is None, getattr(packed, "n_slots", None))


# ---------------------------------------------------------------------------
# participation: each round's sampled hospitals in a fixed slot axis
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParticipationPack:
    """Per-round packing of a participating run (the reference's).

    The hospital axis is ``n_slots`` wide (K for fixed-size sampling).
    ``slot_gid[e, s]`` maps slot ``s`` of round ``e`` to its global
    hospital id (-1 for an empty slot: zero weight, all-False mask);
    ``staleness[e, s]`` counts the rounds that hospital sat out since it
    last took part (0 when fresh or first seen); ``n_batches``,
    ``n_samples`` and ``step_examples`` are per GLOBAL hospital.
    """
    mask: np.ndarray                    # [E, S, NB] bool
    ex_weights: np.ndarray | None       # [E, S, NB, B] float32
    agg_w: np.ndarray                   # [E, S] float32 (data sizes)
    slot_gid: np.ndarray                # [E, S] int32, -1 = empty slot
    part_mask: np.ndarray               # [E, N] bool
    staleness: np.ndarray               # [E, S] float32
    n_batches: list                     # per global hospital
    n_samples: list                     # per global hospital
    step_examples: list                 # per global hospital
    batch_size: int
    shapes: tuple                       # (key, example shape, dtype)

    @property
    def nb_max(self) -> int:
        return self.mask.shape[2]

    @property
    def n_slots(self) -> int:
        return self.mask.shape[1]

    @property
    def n_global(self) -> int:
        return self.part_mask.shape[1]

    def epoch(self, e: int, batches: dict) -> PackedEpoch:
        """Round ``e`` as a ``PackedEpoch`` over the slots (an empty slot
        has no batch and no sample), ``batches`` the run's arrays."""
        gid = self.slot_gid[e]
        nb = [self.n_batches[g] if g >= 0 else 0 for g in gid]
        return PackedEpoch(
            {k: v[e] for k, v in batches.items()}, self.mask[e],
            None if self.ex_weights is None else self.ex_weights[e], nb,
            [self.step_examples[g] if g >= 0 else [] for g in gid],
            [self.n_samples[g] if g >= 0 else 0 for g in gid],
            self.batch_size)


def pack_participation_run(client_data, batch_size: int, rng,
                           n_epochs: int, participation,
                           drop_remainder: bool = True):
    """Pack ``n_epochs`` participating rounds into ``[n_epochs, n_slots,
    nb_max, batch, ...]`` numpy arrays (the reference's packing).

    Every round consumes the data-shuffle ``rng`` for ALL N hospitals in
    global order, exactly the draws ``pack_run`` makes, and only then
    fills the slots with the round's sampled hospitals: a hospital's
    batches depend only on (round, hospital), never on who else was
    sampled, and ``Participation(k=N)`` packs arrays equal to
    ``pack_run``'s.  ``nb_max`` is the largest batch count over ALL N
    hospitals, so the slot grid keeps its shape across rounds.
    """
    N = len(client_data)
    if participation.n_global != N:
        raise ValueError(f"participation.n_global={participation.n_global} "
                         f"but {N} hospitals were passed")
    S = participation.n_slots
    ns = [len(next(iter(d.values()))) for d in client_data]
    counts = [_client_batch_count(n, batch_size, drop_remainder)
              for n in ns]
    nbs = [c[0] for c in counts]
    step_examples = [[batch_size] * nb_full + ([rem] if nb > nb_full else [])
                     for nb, nb_full, rem in counts]
    NB = max(nbs, default=0)
    proto = client_data[0]
    batches = {k: np.zeros((n_epochs, S, NB, batch_size, *v.shape[1:]),
                           v.dtype) for k, v in proto.items()}
    mask = np.zeros((n_epochs, S, NB), bool)
    ex_w = (None if drop_remainder
            else np.zeros((n_epochs, S, NB, batch_size), np.float32))
    agg_w = np.zeros((n_epochs, S), np.float32)
    slot_gid = np.full((n_epochs, S), -1, np.int32)
    part_mask = np.zeros((n_epochs, N), bool)
    staleness = np.zeros((n_epochs, S), np.float32)
    last_seen: dict = {}
    for e in range(n_epochs):
        ids = participation.round_ids(e)
        if len(ids) > S:
            raise ValueError(f"round {e} sampled {len(ids)} hospitals but "
                             f"only {S} slots are packed")
        part_mask[e, ids] = True
        orders = []
        for g in range(N):
            idx = np.arange(ns[g])
            if rng is not None:
                rng.shuffle(idx)
            orders.append(idx)
        for s, g in enumerate(ids):
            g = int(g)
            slot_gid[e, s] = g
            agg_w[e, s] = ns[g]
            prev_e = last_seen.get(g)
            staleness[e, s] = 0.0 if prev_e is None else float(e - prev_e - 1)
            mask[e, s, :nbs[g]] = True
            used = nbs[g] * batch_size if drop_remainder else ns[g]
            for k, v in client_data[g].items():
                batches[k][e, s].reshape(NB * batch_size,
                                         *v.shape[1:])[:used] = (
                    v[orders[g][:used]])
            if ex_w is not None:
                for j, m in enumerate(step_examples[g]):
                    ex_w[e, s, j, :m] = 1.0
            last_seen[g] = e
    shapes = tuple((k, tuple(v.shape[1:]), str(v.dtype))
                   for k, v in proto.items())
    return batches, ParticipationPack(mask, ex_w, agg_w, slot_gid,
                                      part_mask, staleness, nbs, ns,
                                      step_examples, batch_size, shapes)


# ---------------------------------------------------------------------------
# capture and replay
# ---------------------------------------------------------------------------

def _clone(tree, device=None):
    """A copy of every leaf (on ``device``, when given)."""
    if device is None:
        return tree_map(torch.clone, tree)
    return tree_map(lambda t: t.to(device, copy=True), tree)


def _on(tree, device):
    """Every leaf on ``device`` (no copy where it lies there already)."""
    return tree_map(lambda t: t.to(device), tree)


class GraphPool:
    """One memory pool and one stream for every warm-up and capture of a
    strategy's programs, which never replay at once.

    A graph's intermediates are free blocks of its pool between replays,
    and the caching allocator reuses a free block only on the stream that
    freed it: so every capture runs on ``stream``.  The warm-ups of the
    strategy's FIRST program run in ordinary memory: any state a body
    creates lazily on its first call and keeps (an aggregator's device
    table) must not sit in a block that a graph's intermediates overwrite
    at every replay.  A later program's bodies (the observed one's) find
    that state made, and warm up inside the pool (the current thread's
    allocations routed there, the backward pass kept on that thread, as
    PyTorch's own CUDA graph trees warm up), so they run in the memory of
    the first program's graphs instead of beside it: on the U-Net at 768^2
    a step's graph holds tens of GiB."""

    def __init__(self, device: torch.device):
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.programs = 0        # programs with a graph in the pool

    @contextlib.contextmanager
    def warm_up(self, device: torch.device, own: bool):
        """Route the warm-up into the pool when a program other than the
        one warming up (``own``: it has a graph there itself) holds it."""
        if self.programs - own <= 0:
            yield
            return
        torch.cuda.synchronize(device)
        torch._C._cuda_beginAllocateCurrentThreadToPool(device.index,
                                                        self.handle)
        try:
            with torch.autograd.set_multithreading_enabled(False):
                yield
        finally:
            torch._C._cuda_endAllocateToPool(device.index, self.handle)
            torch._C._cuda_releasePool(device.index, self.handle)


def _copy(dst, src):
    tree_map(lambda d, s: d.copy_(s), dst, src)


def opt_counts(opt_state) -> list:
    """The step counts of an optimizer state, its 0-d int64 leaves (Adam's
    ``step``, ``add_noise``'s ``count``), in leaf order."""
    return [l for l in tree_leaves(opt_state)
            if l.dim() == 0 and l.dtype == torch.int64]


def _copy_counts(dst_state, counts) -> None:
    for d, s in zip(opt_counts(dst_state), counts):
        d.copy_(s)


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
    adds the launches its graph holds (``per_replay``).  ``calls`` counts
    each body's runs (replays on the card) and ``capture_s`` each
    capture's host seconds, warm-up included (``obs.profile.
    graph_cost``).  A program holds no reference to its strategy, so
    dropping the strategy frees the graphs' memory pools at once.

    While ``tracer`` is set (an ``obs.trace.Tracer``, for the length of a
    traced run's ``dispatch`` span) each run of a body is timed: on the
    card by two timing events from the program's pool recorded on its
    stream around the replay (not around the call that captures), on the
    CPU by the host clock; ``place_replays`` puts them on the tracer's
    device lane.  Unset, no event is made or recorded.
    """

    bodies: tuple = ("step",)
    #: the ``obs.trace.Tracer`` of a traced run while it dispatches
    tracer = None
    #: the memory pool its graphs capture into (None: a private pool);
    #: programs that never replay at once may share one
    #: (``torch.cuda.graph_pool_handle()``), as the serving scorer's do
    pool = None
    #: a ``GraphPool`` shared with the other programs of a strategy (its
    #: pool and stream for warm-ups and captures), or None
    share = None

    def __init__(self, device: torch.device):
        self.device = device
        self.graphs: dict = {}
        self._launch_deltas: dict = {}  # body -> [(kernel, launches)]
        self._tables: dict = {}         # body -> its graph's GraphTables
        self.calls: dict = {}           # body -> runs (replays on the card)
        self.capture_s: dict = {}       # body -> warm-up + capture seconds
        self.t = torch.zeros((1,), dtype=torch.int64, device=device)
        # the traced run's timed replays, (body, start, end): CUDA events
        # from the pool (two a replay, grown to the largest run) on the
        # card, ``tracer.now()`` readings on the CPU
        self._replays: list = []
        self._events: list = []
        self._anchor = None

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
        self.calls[name] = self.calls.get(name, 0) + 1
        tracer = self.tracer
        if self.device.type != "cuda":
            if tracer is None:
                getattr(self, "_" + name)()
                return
            t0 = tracer.now()
            getattr(self, "_" + name)()
            self._replays.append((name, t0, tracer.now()))
            return
        graph = self.graphs.get(name)
        if graph is None:
            t0 = time.perf_counter()
            graph = self._capture(name)
            torch.cuda.synchronize(self.device)
            self.capture_s[name] = time.perf_counter() - t0
            graph.replay()
        elif tracer is None:
            graph.replay()
        else:
            k = 2 * len(self._replays)
            if k == len(self._events):
                self._events += [torch.cuda.Event(enable_timing=True)
                                 for _ in range(2)]
            begin, end = self._events[k:k + 2]
            stream = torch.cuda.current_stream(self.device)
            begin.record(stream)
            graph.replay()
            end.record(stream)
            self._replays.append((name, begin, end))
        for kernel, n in self._launch_deltas[name]:
            kernel.launches += n

    def _span(self, name: str):
        """A host span of the traced run (inert untraced)."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name)

    def place_replays(self) -> None:
        """Put the run's timed replays on the tracer's device lane, one
        ``replay.<body>`` span each, and forget them.  On the card, once
        the run is read back: one anchor event recorded on the program's
        stream and synchronised on is read against ``tracer.now()``, and
        each stamp lands at that time less its ``elapsed_time`` to the
        anchor."""
        tracer, spans = self.tracer, self._replays
        if spans and self.device.type == "cuda":
            if self._anchor is None:
                self._anchor = torch.cuda.Event(enable_timing=True)
            anchor = self._anchor
            anchor.record(torch.cuda.current_stream(self.device))
            anchor.synchronize()
            now = tracer.now()

            def at(ev):
                return now - ev.elapsed_time(anchor) / 1e3
            spans = [(n, at(a), at(b)) for n, a, b in spans]
        for name, t0, t1 in spans:
            tracer.event("replay." + name, t0, t1, tid=TID_DEVICE)
        self._replays = []

    def _capture(self, name: str):
        body, carry = getattr(self, "_" + name), self.carry()
        saved = [t.clone() for t in carry]
        share = self.share
        main = torch.cuda.current_stream(self.device)
        side = share.stream if share else torch.cuda.Stream(self.device)
        side.wait_stream(main)
        tables = B.GraphTables()
        with torch.cuda.stream(side), tables, (
                share.warm_up(self.device, bool(self.graphs)) if share
                else contextlib.nullcontext()):
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
            with torch.cuda.graph(graph, pool=share.handle if share
                                  else self.pool,
                                  stream=share.stream if share else None), \
                    tables:
                body()
        finally:
            if collecting:
                gc.enable()
        if share and not self.graphs:
            share.programs += 1
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
    strategy's step function (``step_fn``); a placed run's program
    (``chunk``, a ``core.placement.Chunk``) lives on its chunk's device
    and captures in that chunk's ``GraphPool``.

    An observed program (``telemetry``, an ``obs.Telemetry``) steps the
    strategy's observed step function and writes each step's metric taps
    into ``metrics``, one buffer per key of the spec's step keys, shaped
    as the losses; the host reads them once, with the losses, at the end
    of the run.  All of a strategy's programs warm up and capture in its
    one ``GraphPool`` (``Strategy._graph_pool``)."""

    def __init__(self, strategy, packed: PackedEpoch, table, loss_shape,
                 telemetry=None, n_slots=None, chunk=None):
        super().__init__(strategy.device if chunk is None else chunk.device)
        self.share = strategy._graph_pool(chunk)
        self.step_fn = strategy._observed_step(telemetry, n_slots)
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
        self.metrics = {k: torch.zeros(loss_shape, device=dev)
                        for k in strategy._metric_keys(telemetry)}
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

    def load_round(self, rows, ex_w=None, **buffers) -> None:
        """Copy one round in: its step table (the host copy ``rows``, its
        length the round's step count ``n_steps``, at most the table
        buffer's), its remainder weights and the named per-round device
        buffers (``agg_w``, ``staleness``, ``slot_gid``), all outside any
        graph, so one capture of each body serves every round."""
        self.rows = np.ascontiguousarray(rows, dtype=np.int64).reshape(
            -1, self.table.shape[1])
        self.n_steps = len(self.rows)
        self.table[:self.n_steps].copy_(torch.from_numpy(self.rows))
        if ex_w is not None:
            self.ex_w.copy_(torch.from_numpy(np.ascontiguousarray(
                ex_w.reshape(self.ex_w.shape))))
        for name, v in buffers.items():
            getattr(self, name).copy_(torch.from_numpy(np.asarray(v)))

    def record(self, loss, met=None) -> None:
        """Write the step's loss (and metric taps) at row ``t`` of their
        buffers and advance ``t``: device index copies, no host read."""
        self.losses.index_copy_(0, self.t, loss.reshape(
            1, *self.losses.shape[1:]))
        for k, v in (met or {}).items():
            self.metrics[k].index_copy_(0, self.t, v.reshape(
                1, *self.losses.shape[1:]))
        self.t.add_(1)

    def round_metrics(self) -> dict:
        """Per-round taps the round body (or the host round) writes, each
        copied out once an epoch (FL's update cosine)."""
        return {}

    def fill_draws(self, draws) -> None:
        """Copy one step's noise into the noise buffers: the first step's
        draws become the buffers, which every capture and replay reads."""
        if self.draws is None:
            self.draws = draws
        else:
            _copy(self.draws, draws)

    def run(self, batches: dict, draw=None, key_idx=None, end_round=None,
            begin_round=None):
        """Step every epoch of ``batches`` (``pack_run``'s ``[E, C, NB, B,
        ...]`` arrays, or ``pack_participation_run``'s over the slots).
        ``begin_round(e)``, if given, loads round ``e``'s per-round data
        (``load_round``) after its batches (both copies inside a traced
        run's ``h2d`` span); then the ``begin`` body runs,
        if the program has one, and the step body replays once per row of
        the round's table.  A keyed program fills its noise buffers with
        ``draw(key_idx[e][s], rows[s])`` before step ``s`` of epoch ``e``,
        ``rows[s]`` the host row of the step table (which names the step's
        global hospital: no device read inside the step); a key index of 0
        (a masked FL cell) draws nothing.  Each epoch ends in the round
        body, if the program has one, then ``end_round()``, if given.
        Returns the ``[E, *loss_shape]`` device losses (past a round's
        ``n_steps``, what an earlier round left) and the observed metrics
        stacked the same way, ``{key: [E, ...]}`` (empty unobserved),
        per-round taps included; the caller reads them back once
        (``to_host``)."""
        n_epochs = next(iter(batches.values())).shape[0]
        out = torch.empty((n_epochs, *self.losses.shape), device=self.device)
        met = {k: torch.empty((n_epochs, *v.shape), device=self.device)
               for k, v in {**self.metrics, **self.round_metrics()}.items()}
        for e in range(n_epochs):
            with self._span("h2d"):
                for k, buf in self.batches.items():
                    buf.copy_(torch.from_numpy(np.ascontiguousarray(
                        batches[k][e].reshape(buf.shape))))
                if begin_round is not None:
                    begin_round(e)
            self.t.zero_()
            if "begin" in self.bodies:
                self("begin")
            for s in range(self.n_steps):
                i = 0 if draw is None else int(key_idx[e][s])
                if i or (draw is not None and self.draws is None):
                    # a masked first cell still makes the buffers
                    self.fill_draws(draw(i, self.rows[s]))
                self("step")
            out[e].copy_(self.losses)
            for k, v in self.metrics.items():
                met[k][e].copy_(v)
            if "round" in self.bodies:
                self("round")
            if end_round is not None:
                end_round()
            for k, v in self.round_metrics().items():
                met[k][e].copy_(v)
        return out, met


class SeqProgram(_PackedProgram):
    """Centralized: one pooled hospital, persistent params and Adam state
    (``{"params", "opt"}``); one step per batch of the pooled epoch."""

    def __init__(self, strategy, packed: PackedEpoch, state,
                 telemetry=None):
        nb = packed.n_batches[0]
        super().__init__(strategy, packed, np.arange(nb)[:, None], (nb,),
                         telemetry)
        self.params = _clone(state["params"])
        self.opt = _clone(state["opt"])

    def _step(self):
        batch, w = self.batch(self.row()[0:1])
        p, s, loss, *met = self.step_fn(self.params, self.opt, batch, w,
                                        self.draws)
        _copy(self.params, p)
        _copy(self.opt, s)
        self.record(loss, *met)

    def carry(self):
        return [self.t, self.losses, *self.metrics.values(),
                *tree_leaves([self.params, self.opt])]

    def load(self, state):
        _copy(self.params, state["params"])
        _copy(self.opt, state["opt"])

    def store(self, state):
        state["params"], state["opt"] = _clone(self.params), _clone(self.opt)


def fl_rows(mask, gids) -> list:
    """FL's step table over a ``[slots, NB]`` grid, slot-major: each
    cell's (flat batch row, global hospital, valid, first of its slot,
    slot); an empty slot (gid -1) names hospital 0, all its cells
    masked."""
    S, NB = mask.shape
    return [(s * NB + b, max(int(gids[s]), 0), int(mask[s, b]), int(b == 0),
             s) for s in range(S) for b in range(NB)]


class FLProgram(_PackedProgram):
    """FedAvg: every participation slot's local epoch over the ``[S, NB]``
    grid, slot-major.  A slot's first step starts from the global params
    with a fresh Adam; a masked (padding) step is a no-op; the last params
    of each slot land in its row of the stacked locals, and the round body
    replaces the global params by the strategy's ``Aggregator`` of them
    under the round's device buffers ``agg_w`` (the data sizes),
    ``staleness`` and ``slot_gid``.  ``in_graph_round=False`` (secure
    aggregation) does the round on the host instead (``host_round``).
    Observed under ``update_cosine``, the round (either) writes each
    slot's update cosine (``obs.telemetry.update_cosine`` of the locals,
    the old global and the aggregate) into ``cos`` before the global
    params are overwritten.

    A placed chunk's program (``chunk``, a ``core.placement.Chunk``) holds
    that chunk's hospitals (``gids``, their global ids) on its device and
    has no round body: ``core/strategies/placed.py`` gathers every
    chunk's ``locals`` for the round."""

    bodies = ("step", "round")

    def __init__(self, strategy, packed: PackedEpoch, state,
                 in_graph_round: bool = True, telemetry=None, gids=None,
                 chunk=None):
        C, NB = packed.mask.shape
        super().__init__(strategy, packed, fl_rows(
            packed.mask, range(C) if gids is None else gids), (C * NB,),
            telemetry, chunk=chunk)
        self.cos = (torch.zeros((C,), device=self.device)
                    if telemetry is not None and telemetry.update_cosine
                    else None)
        if not in_graph_round:
            self.bodies = ("step",)
        opt, dev = strategy._opt, self.device
        self.agg = strategy._agg
        self.weights = [float(n) for n in packed.n_samples]
        self.agg_w = torch.tensor(self.weights, dtype=torch.float32,
                                  device=dev)
        self.staleness = torch.zeros((C,), device=dev)
        self.slot_gid = torch.zeros((C,), dtype=torch.int64, device=dev)
        self.glob = _clone(state["params"], dev)
        self.local = _clone(state["params"], dev)
        self.fresh = opt.init(self.glob)
        self.local_opt = opt.init(self.glob)
        self.locals = stack_trees([self.glob] * C)

    def _step(self):
        row = self.row()
        batch, w = self.batch(row[0:1])
        first, valid = row[3].bool(), row[2].bool()
        p_in = tree_select(first, self.glob, self.local)
        s_in = tree_select(first, self.fresh, self.local_opt)
        p, s, loss, *met = self.step_fn(p_in, s_in, batch, w, self.draws)
        p = tree_select(valid, p, p_in)
        _copy(self.local, p)
        _copy(self.local_opt, tree_select(valid, s, s_in))
        tree_put(self.locals, row[4:5], p)
        self.record(loss, *met)

    def _round(self):
        new = self.agg.aggregate(self.locals, self.agg_w, self.glob,
                                 self.staleness, self.slot_gid)
        self._observe_round(new)
        _copy(self.glob, new)

    def _observe_round(self, new) -> None:
        if self.cos is not None:
            self.cos.copy_(update_cosine(self.locals, self.glob, new))

    def round_metrics(self) -> dict:
        return {} if self.cos is None else {"update_cosine": self.cos}

    def load_round(self, rows, ex_w=None, **buffers) -> None:
        super().load_round(rows, ex_w, **buffers)
        if "agg_w" in buffers:
            self.weights = [float(w) for w in buffers["agg_w"]]

    def host_round(self, aggregate) -> None:
        """The round on the host instead (secure aggregation): the global
        params become ``aggregate(locals, weights, prev=glob)`` of the
        slots' unstacked locals."""
        locals_ = [tree_map(lambda x, c=c: x[c], self.locals)
                   for c in range(len(self.weights))]
        new = aggregate(locals_, self.weights, prev=self.glob)
        self._observe_round(new)
        _copy(self.glob, new)

    def carry(self):
        return [self.t, self.losses, *self.metrics.values(),
                *self.round_metrics().values(), *tree_leaves(
                    [self.glob, self.local, self.local_opt, self.locals])]

    def load(self, state):
        _copy(self.glob, state["params"])

    def store(self, state):
        state["params"] = _clone(self.glob)


def interleaved_rows(sched, nb_max: int, gids, state_rows=None) -> list:
    """SL/SFLv2's step table in ``sched`` order: each step's (flat batch
    row, global hospital, row of the stacked client state), ``sched``
    holding (slot, batch) pairs, ``gids`` the slots' global hospitals and
    ``state_rows`` their rows in the program's stacked client trees (the
    global ids by default; a placed chunk's own rows)."""
    rows = gids if state_rows is None else state_rows
    return [(int(c) * nb_max + int(b), int(gids[int(c)]),
             int(rows[int(c)])) for c, b in sched]


class InterleavedProgram(_PackedProgram):
    """SL and SFLv2: one sequential server in schedule order.  Each step
    gathers the global hospital's client tree and Adam state (row 1 of the
    step table) from the stacked buffers of all N hospitals by device
    index, runs the split step (a private one with the noise buffers,
    drawn on the host for the hospital of the table's host row) and
    scatters them back; ``sync`` adds the SFLv2 round body (every hospital
    takes the plain mean of the round's sampled hospitals' client trees,
    ``slot_gid``).  The batch buffers are one round's slots wide and the
    step table changes every round (``load_round``): ``capacity`` is the
    longest a round can be, the full-N schedule's length.  A placed
    chunk's program (``chunk``) stacks its own hospitals' client trees
    (``state`` is the chunk's, row 2 of the table indexes it) and holds a
    copy of the server, which ``core/strategies/placed.py`` moves from
    chunk to chunk as the schedule does."""

    def __init__(self, strategy, packed: PackedEpoch, state, capacity: int,
                 sync: bool, telemetry=None, chunk=None):
        super().__init__(strategy, packed, np.zeros((capacity, 3)),
                         (capacity,), telemetry, chunk=chunk)
        if sync:
            self.bodies = ("step", "round")
        dev = self.device
        self.slot_gid = torch.zeros((packed.mask.shape[0],),
                                    dtype=torch.int64, device=dev)
        self.clients = _on(stack_trees(state["clients"]), dev)
        self.c_opts = _on(stack_trees(state["c_opts"]), dev)
        self.server = _clone(state["server"], dev)
        self.s_opt = _clone(state["s_opt"], dev)

    def _step(self):
        row = self.row()
        batch, w = self.batch(row[0:1])
        c = row[2:3]
        cp, sp, co, so, loss, *met = self.step_fn(
            tree_take(self.clients, c), self.server,
            tree_take(self.c_opts, c), self.s_opt, batch, w, self.draws)
        tree_put(self.clients, c, cp)
        tree_put(self.c_opts, c, co)
        _copy(self.server, sp)
        _copy(self.s_opt, so)
        self.record(loss, *met)

    def _round(self):
        rows = tree_map(lambda x: x.index_select(0, self.slot_gid),
                        self.clients)
        tree_map(lambda x, m: x.copy_(m[0].expand_as(x)), self.clients,
                 stacked_mean_sync(rows))

    def carry(self):
        return [self.t, self.losses, *self.metrics.values(), *tree_leaves(
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


def sync_rows(n_batches, nb_max: int, steps: int) -> list:
    """SFLv3/v1's step table: row ``s`` holds each slot's flat batch row
    of step ``s`` (a hospital short of batches wraps around; a phantom
    hospital, with none, reads its all-zero first row)."""
    return [[c * nb_max + (s % nb if nb else 0)
             for c, nb in enumerate(n_batches)] for s in range(steps)]


class SyncProgram(_PackedProgram):
    """SFLv3 and SFLv1: batch-synchronous steps over a round's slots.
    Row ``s`` of the table holds each slot's batch of step ``s``
    (``sync_rows``), and the step is ``sflv3_step_fn``'s: every slot's
    front crosses the cut in one launch per boundary leaf, and a private
    step runs its K4/K5/K6 inside the graph with the noise read from the
    static buffers ``fill_draws`` fills (the first step's draws become
    those buffers).

    The client trees and Adam states of all N hospitals persist in
    stacked buffers: the ``begin`` body gathers the round's sampled
    hospitals (``slot_gid``) into the step's per-slot buffers, the step
    runs the round's steps (as many as its cohort's most batches, at most
    ``capacity``, the largest batch count ``NB_N``), and the round body
    scatters the slots back and, under SFLv1 (``sync``), puts the slots'
    mean into every hospital's row.  The client Adam keeps ONE step count
    for all hospitals (``count``), as the reference's stacked optimizer
    does: it advances with the rounds' steps whoever is sampled (every
    count of a ``chain``'s state, ``opt_counts``, is kept so)."""

    bodies = ("begin", "step", "round")

    def __init__(self, strategy, packed: PackedEpoch, state, sync: bool,
                 capacity: int, telemetry=None, chunk=None):
        S = packed.mask.shape[0]
        super().__init__(strategy, packed, np.zeros((capacity, S)),
                         (capacity, S), telemetry, S, chunk=chunk)
        self.n_slots, self.sync = S, sync
        dev = self.device
        self.slot_gid = torch.zeros((S,), dtype=torch.int64, device=dev)
        self.all_clients = _on(stack_trees(state["clients"]), dev)
        self.all_c_opts = _on(stack_trees(state["c_opts"]), dev)
        self.count = [c.to(dev, copy=True)
                      for c in opt_counts(state["c_opts"][0])]
        self.clients = [_clone(state["clients"][0], dev) for _ in range(S)]
        self.c_opts = [_clone(state["c_opts"][0], dev) for _ in range(S)]
        self.server = _clone(state["server"], dev)
        self.s_opt = _clone(state["s_opt"], dev)

    def _begin(self):
        for j, (cp, co) in enumerate(zip(self.clients, self.c_opts)):
            g = self.slot_gid[j:j + 1]
            _copy(cp, tree_take(self.all_clients, g))
            _copy(co, tree_take(self.all_c_opts, g))
            _copy_counts(co, self.count)

    def _step(self):
        row = self.row()
        batches = [self.batch(row[c:c + 1])[0] for c in range(self.n_slots)]
        clients, server, c_opts, s_opt, losses, *met = self.step_fn(
            self.clients, self.server, self.c_opts, self.s_opt, batches,
            self.draws)
        _copy(self.clients, clients)
        _copy(self.c_opts, c_opts)
        _copy(self.server, server)
        _copy(self.s_opt, s_opt)
        self.record(losses, *met)

    def _round(self):
        for j, (cp, co) in enumerate(zip(self.clients, self.c_opts)):
            g = self.slot_gid[j:j + 1]
            tree_put(self.all_clients, g, cp)
            tree_put(self.all_c_opts, g, co)
        _copy(self.count, opt_counts(self.c_opts[0]))
        if self.sync:
            tree_map(lambda x, a: x.copy_(a.expand_as(x)), self.all_clients,
                     tree_mean(self.clients))

    def carry(self):
        return [self.t, self.losses, *self.metrics.values(), *tree_leaves(
            [self.clients, self.c_opts, self.server, self.s_opt,
             self.all_clients, self.all_c_opts, self.count])]

    def load(self, state):
        _copy(self.all_clients, stack_trees(state["clients"]))
        _copy(self.all_c_opts, stack_trees(state["c_opts"]))
        _copy(self.count, opt_counts(state["c_opts"][0]))
        _copy(self.server, state["server"])
        _copy(self.s_opt, state["s_opt"])

    def store(self, state):
        n = len(state["clients"])
        state["clients"] = [tree_map(lambda x, c=c: x[c].clone(),
                                     self.all_clients) for c in range(n)]
        state["c_opts"] = [tree_map(lambda x, c=c: x[c].clone(),
                                    self.all_c_opts) for c in range(n)]
        for co in state["c_opts"]:
            _copy_counts(co, self.count)
        state["server"], state["s_opt"] = (_clone(self.server),
                                           _clone(self.s_opt))


def program_for(strategy, kind, packed, build):
    """The strategy's program of this packed layout (a ``PackedEpoch``, or
    a ``ParticipationPack``) under its active telemetry spec, built by
    ``build(telemetry)`` the first time (one capture per program body,
    none per round, epoch or run).  Observed programs are cached apart
    from the unobserved ones, keyed on the spec, so observing never evicts
    or recaptures an unobserved program's graphs."""
    keys = strategy.adapter.batch_keys or tuple(s[0] for s in packed.shapes)
    tel = strategy._tel
    key = (kind, layout_key(packed, keys)) + ((tel,) if tel else ())
    prog = strategy._programs.get(key)
    if prog is None:
        prog = strategy._programs[key] = build(tel)
    return prog


def to_host(losses, metrics: dict):
    """A run's device losses and metrics -> numpy, in ONE device-to-host
    copy (the run's one readback)."""
    if not metrics:
        return losses.cpu().numpy(), {}
    parts = [losses, *metrics.values()]
    flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
    out, off = [], 0
    for p in parts:
        out.append(flat[off:off + p.numel()].reshape(p.shape))
        off += p.numel()
    return out[0], dict(zip(metrics, out[1:]))


__all__ = ["PackedEpoch", "pack_epoch", "pack_run", "empty_run",
           "ParticipationPack", "pack_participation_run",
           "client_major_log", "scheduled_log",
           "GraphPool", "Program", "SeqProgram", "FLProgram",
           "InterleavedProgram", "SyncProgram", "fl_rows",
           "interleaved_rows", "sync_rows", "program_for", "to_host"]
