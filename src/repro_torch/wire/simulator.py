"""Event-driven replay of one training epoch's transfers over a network.

``build_transfers`` expands a method's per-epoch communication (the SAME
legs ``repro_torch.core.comm`` counts analytically — both sit on
``client_batch_counts``/``leg_sizes`` so the byte totals can never drift)
into a dependency DAG of one-way transfers (the counterpart of
``repro/wire/simulator.py``, host code over the port's ``core.comm``,
``core.schedule`` and ``wire.transport``: the same transfers, draws and
timelines as the reference's on the same inputs):

  * ``sl_*``    — one long chain: the server segment is sequential, so every
                  (client, batch) hop serializes (act up, [hidden down,
                  hidden-grad up,] grad down).
  * ``sflv2_*`` — the SL chain plus an end-of-epoch client-segment
                  fed-averaging barrier (all ups, then all downs).
  * ``sflv3_*`` — batch-synchronous parallel steps: per step every active
                  client uplinks concurrently, the server averages (barrier),
                  then all gradients flow down concurrently.
  * ``fl``      — one round: model down to every client, local training
                  (no cut-layer traffic), model up.

``replay`` is the event engine: a ready-queue (heap) of transfers whose
dependencies have completed, each serialized on its client's link and
stretched by the network model's bandwidth/latency/jitter/straggler draw.
The output is a per-client timeline, the epoch wall-clock, and exact
bytes-on-wire per leg tag.

``timeline_from_accounting`` is the analytic->timeline bridge: it expands
the per-epoch schedule signatures a ``Transport`` recorded during REAL
training (``Transport.record_epoch`` + the compiled engine's
``account(count=n_batches)`` summaries) through the SAME per-epoch
expansion ``build_transfers`` uses, chained across epochs — so simulated
wall-clocks and per-tag byte breakdowns are identical whichever engine
trained, per-step or analytic accounting.

Note the simulator follows the ANALYTIC step grid: an SFLv3 client with
fewer local batches drops out of later steps, while the reference
``SplitFedV3.run_epoch`` wraps exhausted clients around (re-sending
duplicate batches).  DESIGN.md §7 records this choice — it is what keeps
the identity-codec simulation equal to paper Table 4.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict

import numpy as np

from repro_torch.core.comm import (client_batch_counts, comm_per_epoch,
                                   leg_sizes)
from repro_torch.core.schedule import SCHEDULES
from repro_torch.wire.codec import Codec, IdentityCodec, make_codec
from repro_torch.wire.network import NetworkModel, make_network
from repro_torch.wire.transport import EpochSchedule, Transport

@dataclasses.dataclass(frozen=True)
class Transfer:
    """One one-way transfer in the epoch DAG."""
    id: int
    client: int
    nbytes: float
    direction: str               # "up" | "down"
    tag: str                     # comm.py breakdown key
    deps: tuple = ()


@dataclasses.dataclass(frozen=True)
class WireEvent:
    t_start: float
    t_end: float
    client: int
    direction: str
    nbytes: float
    tag: str


@dataclasses.dataclass
class SimResult:
    method: str
    codec: str
    scenario: str
    n_clients: int
    wall_clock_s: float
    bytes_on_wire: float
    bytes_raw: float
    breakdown: dict              # tag -> bytes
    per_client: dict             # client -> {busy_s, idle_frac, transfers}
    events: list

    @property
    def compression_ratio(self) -> float:
        # nothing crossed the wire (e.g. centralized): no ratio — mirror
        # Transport.compression_ratio instead of reporting bytes_raw / 1
        if self.bytes_on_wire <= 0:
            return float("nan")
        return self.bytes_raw / self.bytes_on_wire

    def timeline(self, client: int) -> list:
        return [e for e in self.events if e.client == client]


class _Dag:
    def __init__(self):
        self.transfers: list[Transfer] = []

    def add(self, client, nbytes, direction, tag, deps=()) -> int:
        tid = len(self.transfers)
        self.transfers.append(Transfer(tid, client, float(nbytes), direction,
                                       tag, tuple(deps)))
        return tid


def _train_leg_seq(dag: _Dag, client: int, legs: dict, nls: bool,
                   deps) -> int:
    """One train step's cut-layer hops for one client; returns last id.

    NLS hops: the server's hidden output travels DOWN to the client's
    tail, its gradient travels back UP — tags follow the directions
    (matching ``core.comm``'s breakdown keys).
    """
    t = dag.add(client, legs["act_fm"], "up", "train_act_up", deps)
    if nls:
        t = dag.add(client, legs["act_mt"], "down", "train_hidden_down",
                    [t])
        t = dag.add(client, legs["act_mt"], "up", "train_hidden_grad_up",
                    [t])
    return dag.add(client, legs["act_fm"], "down", "train_grad_down", [t])


def _val_leg_seq(dag: _Dag, client: int, legs: dict, nls: bool, deps) -> int:
    t = dag.add(client, legs["act_fm"], "up", "val_act_up", deps)
    if nls:
        t = dag.add(client, legs["act_mt"], "down", "val_hidden_down", [t])
    return t


def _expand_epoch(dag: _Dag, es: EpochSchedule, va_counts: list[int],
                  entry: dict) -> dict:
    """Expand ONE epoch's transfers (train legs, per-epoch validation,
    client-segment averaging) for a cut-layer method.

    ``entry`` maps each client to the transfer ids that must complete
    before its first transfer of this epoch (empty for a fresh DAG; the
    previous epoch's exits when chaining a multi-epoch run); the return
    value is this epoch's exits in the same form.  Shared verbatim by
    ``build_transfers`` (one analytic epoch) and
    ``timeline_from_accounting`` (each recorded epoch of a real run), so
    the two can never drift apart.
    """
    legs, nls = es.legs, es.nls
    n_clients = len(es.tr_counts)

    if es.kind in ("sl", "sflv2"):
        # sequential server: the whole epoch is one chain across clients
        last = tuple(sorted({d for deps in entry.values() for d in deps}))
        for c, _b in SCHEDULES[es.schedule](list(es.tr_counts)):
            last = (_train_leg_seq(dag, c, legs, nls, last),)
        for c, nb in enumerate(va_counts):
            for _ in range(nb):
                last = (_val_leg_seq(dag, c, legs, nls, last),)
        if es.kind == "sflv2":
            ups = [dag.add(c, legs["client_seg"], "up", "client_seg_avg",
                           last) for c in range(n_clients)]
            return {c: (dag.add(c, legs["client_seg"], "down",
                                "client_seg_avg", ups),)
                    for c in range(n_clients)}
        return {c: last for c in range(n_clients)}

    if es.kind in ("sflv3", "sflv1"):
        # batch-synchronous parallel steps with a server barrier per step
        barrier = {c: tuple(entry.get(c, ())) for c in range(n_clients)}
        for s in range(max(es.tr_counts, default=0)):
            active = [c for c in range(n_clients) if s < es.tr_counts[c]]
            chains = {}
            for c in active:
                t = dag.add(c, legs["act_fm"], "up", "train_act_up",
                            barrier[c])
                if nls:
                    t = dag.add(c, legs["act_mt"], "down",
                                "train_hidden_down", [t])
                    t = dag.add(c, legs["act_mt"], "up",
                                "train_hidden_grad_up", [t])
                chains[c] = t
            # server averages once every active client's gradient arrived
            ups = list(chains.values())
            for c in active:
                barrier[c] = (dag.add(c, legs["act_fm"], "down",
                                      "train_grad_down", ups),)
        if es.kind == "sflv1":
            ups = [dag.add(c, legs["client_seg"], "up", "client_seg_avg",
                           barrier[c]) for c in range(n_clients)]
            barrier = {c: (dag.add(c, legs["client_seg"], "down",
                                   "client_seg_avg", ups),)
                       for c in range(n_clients)}
        # validation: per-client chains, clients run concurrently
        exits = {}
        for c in range(n_clients):
            last = barrier[c]
            for _ in range(va_counts[c] if c < len(va_counts) else 0):
                last = (_val_leg_seq(dag, c, legs, nls, last),)
            exits[c] = last
        return exits

    raise KeyError(f"unknown method kind {es.kind!r}")


def build_transfers(method: str, adapter, example_batch: dict,
                    n_train: list[int], n_val: list[int], batch_size: int,
                    codec: Codec | None = None) -> list[Transfer]:
    """Expand one epoch of ``method`` into the transfer DAG."""
    codec = codec or IdentityCodec()
    legs = leg_sizes(adapter, example_batch, codec=codec)
    tr_counts, va_counts = client_batch_counts(n_train, n_val, batch_size)
    n_clients = len(n_train)
    dag = _Dag()

    if method == "centralized":
        return dag.transfers

    if method == "fl":
        for c in range(n_clients):
            down = dag.add(c, legs["model"], "down", "model_down")
            dag.add(c, legs["model"], "up", "model_up", [down])
        return dag.transfers

    kind, _, schedule = method.partition("_")
    es = EpochSchedule(kind, schedule or "ac", tuple(tr_counts), legs,
                       adapter.nls)
    _expand_epoch(dag, es, va_counts, {c: () for c in range(n_clients)})
    return dag.transfers


def replay(transfers: list[Transfer], network: NetworkModel,
           n_clients: int, seed: int = 0,
           multipliers: np.ndarray | None = None) -> list[WireEvent]:
    """Run the event loop: pop ready transfers, serialize per client link."""
    rng = np.random.default_rng(seed)
    if multipliers is None:
        multipliers = network.client_multipliers(n_clients, rng)
    children = defaultdict(list)
    missing = {}
    ready_at = defaultdict(float)
    for t in transfers:
        missing[t.id] = len(t.deps)
        for d in t.deps:
            children[d].append(t.id)
    heap = [(0.0, t.id) for t in transfers if not t.deps]
    heapq.heapify(heap)
    client_free = defaultdict(float)
    events: list[WireEvent | None] = [None] * len(transfers)
    done = 0
    while heap:
        t_ready, tid = heapq.heappop(heap)
        tr = transfers[tid]
        start = max(t_ready, client_free[tr.client])
        dur = network.transfer_time(tr.nbytes, rng,
                                    multipliers[tr.client])
        end = start + dur
        client_free[tr.client] = end
        events[tid] = WireEvent(start, end, tr.client, tr.direction,
                                tr.nbytes, tr.tag)
        done += 1
        for ch in children[tid]:
            ready_at[ch] = max(ready_at[ch], end)
            missing[ch] -= 1
            if missing[ch] == 0:
                heapq.heappush(heap, (ready_at[ch], ch))
    if done != len(transfers):
        raise RuntimeError("transfer DAG has a cycle or dangling dependency")
    return [e for e in events if e is not None]


def _replay_to_result(transfers, network, n_clients: int, method: str,
                      codec_name: str, bytes_raw: float, seed: int,
                      multipliers, keep_events: bool) -> SimResult:
    """Run the event engine over ``transfers`` and fold the events into a
    ``SimResult`` (wall-clock, per-tag breakdown, per-client stats)."""
    events = replay(transfers, network, n_clients, seed, multipliers)
    wall = max((e.t_end for e in events), default=0.0)
    breakdown = defaultdict(float)
    per_client = {c: {"busy_s": 0.0, "transfers": 0, "bytes": 0.0}
                  for c in range(n_clients)}
    for e in events:
        breakdown[e.tag] += e.nbytes
        pc = per_client[e.client]
        pc["busy_s"] += e.t_end - e.t_start
        pc["transfers"] += 1
        pc["bytes"] += e.nbytes
    for pc in per_client.values():
        pc["idle_frac"] = 1.0 - pc["busy_s"] / wall if wall > 0 else 0.0
    return SimResult(method=method, codec=codec_name,
                     scenario=network.name, n_clients=n_clients,
                     wall_clock_s=wall,
                     bytes_on_wire=float(sum(e.nbytes for e in events)),
                     bytes_raw=float(bytes_raw),
                     breakdown=dict(breakdown), per_client=per_client,
                     events=events if keep_events else [])


def simulate(method: str, adapter, example_batch: dict, n_train: list[int],
             n_val: list[int], batch_size: int, codec="identity",
             network="hospital_wan", seed: int = 0,
             multipliers: np.ndarray | None = None,
             keep_events: bool = True) -> SimResult:
    """One epoch of ``method`` through ``codec`` over ``network``."""
    codec = make_codec(codec)
    network = make_network(network)
    n_clients = len(n_train)
    transfers = build_transfers(method, adapter, example_batch, n_train,
                                n_val, batch_size, codec)
    raw = comm_per_epoch(method, adapter, example_batch, n_train, n_val,
                         batch_size).bytes_per_epoch
    return _replay_to_result(transfers, network, n_clients, method,
                             codec.name, raw, seed, multipliers,
                             keep_events)


def _epoch_raw_bytes(es: EpochSchedule, va_counts: list[int]) -> float:
    """Uncompressed bytes of one recorded epoch's legs (mirrors the
    ``comm_per_epoch`` terms for the cut-layer methods)."""
    tb, vb = sum(es.tr_counts), sum(va_counts)
    raw = es.legs["act_fm_raw"] * (2 * tb + vb)
    if es.nls:
        raw += es.legs["act_mt_raw"] * (2 * tb + vb)
    if es.kind in ("sflv2", "sflv1"):
        raw += 2 * es.legs["client_seg"] * len(es.tr_counts)
    return float(raw)


def timeline_from_accounting(transport: Transport, n_val=None,
                             batch_size: int | None = None,
                             network="hospital_wan", seed: int = 0,
                             multipliers: np.ndarray | None = None,
                             keep_events: bool = True) -> SimResult:
    """Replay a TRAINED transport's accounting as per-step timelines.

    Expands the per-epoch schedule signatures the transport recorded
    during training (``Transport.record_epoch`` — written identically by
    the stepwise per-step accounting and the compiled engine's analytic
    ``account(count=n_batches)`` summaries) through the same
    ``_expand_epoch`` that ``build_transfers`` uses, chaining each
    epoch's entry transfers on the previous epoch's exits, and replays
    the DAG through the event engine.  With ``n_val``/``batch_size``
    given, every epoch closes with the validation legs ``simulate``
    models; a single-epoch result is then transfer-for-transfer identical
    to ``simulate`` on the same network and seed, whichever engine
    trained.

    Like ``simulate``, the expansion follows the analytic step grid
    (DESIGN.md §7): an SFLv3 client with fewer batches drops out of later
    steps rather than wrapping around, so for uneven hospitals the
    timeline's bytes are the Table-4 analytic total, not the transport's
    wrap-around-inclusive counters.
    """
    recs = list(transport.epoch_log)
    network = make_network(network)
    if not recs:
        return SimResult(method="", codec=transport.codec.name,
                         scenario=network.name, n_clients=0,
                         wall_clock_s=0.0, bytes_on_wire=0.0,
                         bytes_raw=0.0, breakdown={}, per_client={},
                         events=[])
    n_clients = len(recs[0].tr_counts)
    va_counts = [0] * n_clients
    if n_val is not None:
        if batch_size is None:
            raise ValueError("n_val needs batch_size to derive val batch "
                             "counts")
        _, va_counts = client_batch_counts([0] * n_clients, n_val,
                                           batch_size)
    dag = _Dag()
    entry = {c: () for c in range(n_clients)}
    raw = 0.0
    for es in recs:
        if len(es.tr_counts) != n_clients:
            raise ValueError("recorded epochs disagree on client count")
        entry = _expand_epoch(dag, es, va_counts, entry)
        raw += _epoch_raw_bytes(es, va_counts)
    method = f"{recs[0].kind}_{recs[0].schedule}"
    return _replay_to_result(dag.transfers, network, n_clients, method,
                             transport.codec.name, raw, seed, multipliers,
                             keep_events)


def straggler_sensitivity(method: str, adapter, example_batch: dict,
                          n_train: list[int], n_val: list[int],
                          batch_size: int, codec="identity",
                          network="hospital_wan", seed: int = 0) -> float:
    """Epoch wall-clock ratio: with stragglers / straggler-free.

    Parallel barrier methods (SFLv3, FL) pay the slowest client every
    step/round; sequential SL only pays stragglers for their own turns.
    """
    network = make_network(network)
    with_s = simulate(method, adapter, example_batch, n_train, n_val,
                      batch_size, codec, network, seed, keep_events=False)
    clean = simulate(method, adapter, example_batch, n_train, n_val,
                     batch_size, codec, network.without_stragglers(), seed,
                     keep_events=False)
    return with_s.wall_clock_s / max(clean.wall_clock_s, 1e-12)
