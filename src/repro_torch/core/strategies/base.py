"""Strategy API + the step functions — counterpart of
``repro/core/strategies/base.py``: ``full_step_fn`` (centralized, FL),
``split_step_fn`` (SL, SFLv2) and ``sflv3_step_fn`` (SFLv3, SFLv1).

Two engines run the SAME step functions:
  * ``compiled`` (the default; ``engine.py``): a whole epoch, or a whole
    ``Strategy.run``, packed on the device (pad-and-mask) and stepped by
    one captured CUDA graph of the step, replayed;
  * ``stepwise``: a Python loop that calls the step once per mini-batch,
    kept as the parity oracle.

Every strategy consumes a ``SplitAdapter`` and an optimizer factory and
exposes ``setup(seed) -> state``, ``run_epoch(state, client_data, rng,
batch_size) -> (state, log)``, ``evaluate``, ``val_loss`` and ``scores``.
``client_data`` is a list (one per hospital) of dicts of numpy arrays;
batches are drawn on the host with the reference's numpy rng stream and
moved to the strategy's device.  Evaluation follows the paper (§3.4): a
sample from hospital i always passes through hospital i's own client
segment(s).
"""

from __future__ import annotations

import contextlib
import dataclasses
import types
from typing import Callable

import numpy as np
import torch

from repro_torch.core.participation import Participation, as_participation
from repro_torch.core.partition import (SplitAdapter, as_meta, detached,
                                        grid_scores)
from repro_torch.obs import telemetry as T
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.privacy.dpsgd import (crossings, cut_noise_boundary,
                                       dp_value_and_grad, first_rows,
                                       hospital_draws)
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class EpochLog:
    """Per-epoch training log.

    ``weights`` are per-step valid-example counts (None: every step saw a
    full batch); ``mean_loss`` is the example-weighted mean, so a compiled
    (pad-and-mask) epoch and a stepwise epoch over the same data report
    the same statistics.  ``client_steps`` counts the optimizer steps of
    each hospital (masked padding steps excluded).  ``telemetry`` is the
    epoch's ``obs.telemetry.RoundTelemetry`` when it ran observed."""
    losses: list
    steps: int
    weights: list | None = None
    client_steps: list[int] | None = None
    telemetry: object = None

    @property
    def mean_loss(self):
        if not self.losses:
            return float("nan")
        if self.weights is None:
            return float(np.mean(self.losses))
        w = np.asarray(self.weights, dtype=np.float64)
        l = np.asarray(self.losses, dtype=np.float64)
        return float((l * w).sum() / max(w.sum(), 1.0))


def np_batches(data: dict, batch_size: int, rng: np.random.Generator | None,
               drop_remainder: bool = True):
    """Shuffle + slice a client's epoch into batch dicts (the reference's
    numpy stream: the same rng gives the same batches).
    ``drop_remainder=True`` drops the final ``n % batch_size`` samples, as
    the paper's testbed does; ``False`` keeps them as one short final
    batch."""
    n = len(next(iter(data.values())))
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    return [{k: v[idx[s:s + batch_size]] for k, v in data.items()}
            for s in range(0, stop, batch_size)]


class Strategy:
    name: str = "base"
    #: every hospital scores with the same params (centralized, FL); an
    #: export records it, as the reference's does
    shared_eval_params: bool = False
    #: centralized: the epsilon series composes at the pooled rate
    _eps_pooled: bool = False
    #: the step crosses a cut layer (the cut statistics apply)
    _has_cut: bool = False

    def __init__(self, adapter: SplitAdapter, opt_factory: Callable[[], Optimizer],
                 n_clients: int, device: torch.device, privacy=None,
                 engine: str = "compiled", drop_remainder: bool = True,
                 participation=None, observe=None, shard: bool = False,
                 devices=None):
        if engine not in ("stepwise", "compiled"):
            raise ValueError(f"unknown engine {engine!r}")
        self.participation = as_participation(participation)
        if self.participation is not None:
            if self.participation.n_global != n_clients:
                raise ValueError(
                    f"participation.n_global={self.participation.n_global} "
                    f"!= n_clients={n_clients}")
            if engine != "compiled":
                raise ValueError(
                    "participation= requires the compiled engine (the "
                    "stepwise oracle has no slot-packed hospital axis)")
            if shard:
                raise ValueError("participation= with shard= is not "
                                 "supported (slot axis vs mesh padding)")
        # pad-to-devices hospital-axis placement (the identity on one
        # device; the stepwise parity oracle never pads or places)
        from repro_torch.core.placement import Placement
        self.shard = shard
        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if device.type == "cuda" else [device])
        self.placement = Placement.make(
            n_clients, enabled=shard and engine == "compiled",
            devices=devices)
        self.adapter = adapter
        self.opt_factory = opt_factory
        self.n_clients = n_clients
        self.device = device
        self.privacy = privacy      # repro_torch.privacy.PrivacyConfig | None
        self.engine = engine
        self.drop_remainder = drop_remainder
        self._accountants = None
        self._key_step = 0
        self._spec_cache: dict = {}     # batch shape -> cut noise specs
        # the compiled engine's programs, one per packed layout and
        # telemetry spec, all captured into one memory pool (two programs
        # of a strategy never replay at once)
        self._programs: dict = {}
        self._pools: dict = {}          # chunk index -> GraphPool
        # observability (repro_torch.obs): the metric-tap spec, the span
        # tracer and the dispatch counters, all inert when unused
        self.observe = T.as_telemetry(observe)
        self._tel_active = self.observe
        self._obs_steps: dict = {}      # (spec, slots) -> observed step
        self._tracer = None
        self._dispatches = 0
        self._run_calls = 0
        self._last_run = None           # graph_cost's record of the run
        self.last_run_telemetry = None

    # -- to implement ---------------------------------------------------------
    def setup(self, seed=0):
        raise NotImplementedError

    def run_epoch(self, state, client_data, rng, batch_size):
        """One epoch (round) of EVERY hospital, as the reference's
        ``run_epoch`` (participation applies to ``run`` only); returns
        ``(state, log)``."""
        if self.engine == "compiled":
            return self._run_epoch_compiled(state, client_data, rng,
                                            batch_size)
        return self._run_epoch_stepwise(state, client_data, rng, batch_size)

    def _run_epoch_stepwise(self, state, client_data, rng, batch_size):
        raise NotImplementedError

    def _run_compiled(self, state, client_data, rng, batch_size, n_epochs,
                      participation=None):
        """``n_epochs`` epochs (rounds) as one replayed program
        (``engine.py``), each round training the hospitals
        ``participation`` samples (None: every hospital); None when the
        run trains nothing."""
        raise NotImplementedError

    def _cohort(self, participation):
        """The rounds' sampling spec: ``participation``, or every hospital
        every round, ``Participation(k=N)``, which packs, steps and
        accounts exactly as a run without participation."""
        return participation or Participation(n_global=self.n_clients,
                                              k=self.n_clients)

    def _run_epoch_compiled(self, state, client_data, rng, batch_size):
        out = self._run_compiled(state, client_data, rng, batch_size, 1)
        if out is None:
            # no hospital has a batch: the loop trains nothing, and draws
            # the shuffles the stepwise engine draws
            return self._run_epoch_stepwise(state, client_data, rng,
                                            batch_size)
        state, logs = out
        return state, logs[0]

    def params_for_eval(self, state, client_idx) -> dict:
        """Full param dict (all segments) used to score client ``client_idx``."""
        raise NotImplementedError

    def run(self, state, client_data, rng, batch_size, n_epochs,
            observe=None):
        """Train ``n_epochs`` epochs (rounds); returns ``(state, logs)``,
        one ``EpochLog`` per epoch.  The compiled engine packs the whole
        run up front (the same host shuffles and step-key indices as the
        epoch loop, in the same order) and steps it with one program;
        a run in which no hospital has a batch, and the stepwise engine,
        run the epochs one after another.  Under ``participation`` each
        round trains only its sampled hospitals (a run that trains nothing
        returns no logs).

        ``observe`` (``obs.Telemetry`` | True | False | None) overrides
        the constructor's telemetry spec for this run: the metric taps
        run inside the captured steps and land in device buffers beside
        the losses (the run replays as many graphs as an unobserved one,
        and params are bit-equal to an unobserved run's), and the reduced
        per-round telemetry lands on each ``EpochLog.telemetry`` and on
        ``self.last_run_telemetry``.  ``None`` inherits the constructor's
        spec; ``False`` turns it off for this run."""
        if n_epochs <= 0:
            return state, []
        tel = (self.observe if observe is None
               else None if observe is False else T.as_telemetry(observe))
        prev, self._tel_active = self._tel_active, tel
        try:
            with self._span("run", strategy=self.name, n_epochs=n_epochs):
                if self.engine == "compiled":
                    out = self._run_compiled(state, client_data, rng,
                                             batch_size, n_epochs,
                                             self.participation)
                    if out is not None:
                        state, logs = out
                        return state, self._finish_run(client_data,
                                                       batch_size, logs)
                    if self.participation is not None:
                        return state, self._finish_run(client_data,
                                                       batch_size, [])
                logs = []
                for i in range(n_epochs):
                    with self._span(f"round {i}"):
                        state, log = self.run_epoch(state, client_data, rng,
                                                    batch_size)
                    logs.append(log)
                return state, self._finish_run(client_data, batch_size,
                                               logs)
        finally:
            self._tel_active = prev

    def _finish_run(self, client_data, batch_size, logs):
        """Assemble ``last_run_telemetry`` (one RoundTelemetry per epoch
        plus the per-round cumulative RDP epsilon series) from the logs an
        observed run produced."""
        tel = self._tel
        if tel is None:
            self.last_run_telemetry = None
            return logs
        rounds = []
        for i, log in enumerate(logs):
            r = log.telemetry
            if r is None:
                r = T.RoundTelemetry(i, {})
                log.telemetry = r
            r.round_index = i
            rounds.append(r)
        if tel.epsilon and self._dp:
            ns = [len(d["label"]) for d in client_data]
            kw = {}
            part = self.participation
            if part is not None and part.kind != "schedule":
                # amplification: every hospital composes every round at
                # the amplified rate over its would-be step count (the
                # realized zeros of unsampled rounds don't apply here);
                # deterministic schedules keep the realized client_steps
                kw = dict(q_scale=part.rate,
                          steps_override=getattr(self, "_last_part_nbs",
                                                 None))
            eps = T.epsilon_rounds(self.privacy, logs, ns, batch_size,
                                   pooled=self._eps_pooled, **kw)
            if eps is not None:
                for r, e in zip(rounds, eps):
                    r.epsilon = e
        self.last_run_telemetry = T.RunTelemetry(self.name, self.n_clients,
                                                 rounds)
        return logs

    # -- observability plumbing (repro_torch.obs) ----------------------------
    @property
    def _tel(self):
        """The active Telemetry spec (run()'s override or the
        constructor's)."""
        return self._tel_active

    def attach_tracer(self, tracer):
        """Attach an ``obs.trace.Tracer`` (None detaches it): the host
        phases (``run``, ``pack``, ``dispatch``, ``h2d`` inside it, one an
        epoch, ``val_loss``, and ``round i`` on the per-epoch path) are
        recorded as spans, and every replay of a compiled run as a
        ``replay.<body>`` span on the tracer's device lane
        (``_dispatching``).  ``dispatch`` is host time: the replay loop
        up to the run's one readback, where the host waits for the device
        (the batch copies from pageable host memory also wait for the
        work before them).  The device's time is the ``replay.*`` spans;
        the gaps between them are the device's idle time in the run."""
        self._tracer = tracer
        return tracer

    def _span(self, name, **args):
        if self._tracer is None:
            return contextlib.nullcontext()
        return self._tracer.span(name, **args)

    @contextlib.contextmanager
    def _dispatching(self, progs):
        """The ``dispatch`` span of one compiled run of ``progs`` (a
        program, or a placed run's list): with a tracer attached, the
        programs time their replays for the span's length
        (``engine.Program.tracer``) and place them on its device lane
        before it closes, after the run's readback (a placed run's
        anchors wait for its devices)."""
        tracer = self._tracer
        if tracer is None:
            yield
            return
        progs = progs if isinstance(progs, list) else [progs]
        with tracer.span("dispatch"):
            for p in progs:
                p.tracer = tracer
            try:
                yield
                for p in progs:
                    p.place_replays()
            finally:
                for p in progs:
                    p.tracer, p._replays = None, []

    def _count_dispatch(self, n: int = 1):
        """Tally host->device training-program invocations: a stepwise
        step counts one, a compiled run one per replay (``Program.calls``:
        each step, and each begin and round body)."""
        self._dispatches += n

    def _observed_step(self, tel, n_slots=None):
        """The step function of spec ``tel`` (None: unobserved) over
        ``n_slots`` hospitals (SFLv3/v1's participating step; None: every
        hospital): the unobserved full step is ``_step``, any other is
        built once per (spec, slot count) by ``_make_step`` and kept apart
        from it, as the reference's ``_get_obs`` keeps its observed
        programs."""
        if n_slots == self.n_clients:
            n_slots = None
        if tel is None and n_slots is None:
            return self._step
        key = (tel, n_slots)
        if key not in self._obs_steps:
            self._obs_steps[key] = self._make_step(tel, n_slots)
        return self._obs_steps[key]

    def _make_step(self, telemetry=None, n_slots=None):
        """The strategy's step function under ``telemetry`` over
        ``n_slots`` hospitals (None: ``n_clients``)."""
        raise NotImplementedError

    def _metric_keys(self, tel) -> tuple:
        """The per-step metric keys an observed step of ``tel`` emits."""
        if tel is None:
            return ()
        return tel.step_keys(dp=self._dp, cut=self._has_cut)

    def _graph_pool(self, chunk=None):
        """The ``engine.GraphPool`` every program of this strategy (of a
        placed run, of its ``chunk``: one pool and stream per chunk index,
        on the chunk's device) warms up and captures in (None on the CPU):
        programs never replay at once, so an observed program reuses the
        memory of the unobserved one's graphs instead of holding a second
        pool beside it."""
        dev = self.device if chunk is None else chunk.device
        k = 0 if chunk is None else chunk.index
        if k not in self._pools and dev.type == "cuda":
            from repro_torch.core.strategies.engine import GraphPool
            self._pools[k] = GraphPool(dev)
        return self._pools.get(k)

    @property
    def _placed(self) -> bool:
        """A compiled run goes through ``placed.py``: the placement splits
        the hospital axis over devices, or pads it with phantoms."""
        return self.placement.enabled or self.placement.padded

    def _dispatch(self, progs, calls_before, per_step):
        """Book one compiled run of ``progs`` (a program, or a placed
        run's list of chunk programs with a list of ``calls_before``):
        their replays as dispatches, one run call, and the record
        ``obs.profile.graph_cost`` reads (the first program, the replays
        of all in this run, the hospitals one step trains, the peak
        memory)."""
        if not isinstance(progs, list):
            progs, calls_before = [progs], [calls_before]
        calls = {}
        for prog, before in zip(progs, calls_before):
            for k, n in prog.calls.items():
                calls[k] = calls.get(k, 0) + n - before.get(k, 0)
        self._count_dispatch(sum(calls.values()))
        self._run_calls += 1
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else None)
        self._last_run = dict(program=progs[0], replays=calls,
                              per_step=per_step, peak_bytes=peak)

    def _host_metrics(self, mets: list) -> dict:
        """A stepwise epoch's per-step metric dicts -> ``{key: [steps,
        ...] numpy}``, read back in one copy."""
        if not mets or not mets[0]:
            return {}
        keys = list(mets[0])
        stacked = torch.stack([torch.stack([m[k] for k in keys])
                               for m in mets]).cpu().numpy()
        return {k: stacked[:, i] for i, k in enumerate(keys)}

    # -- privacy plumbing -----------------------------------------------------
    @property
    def _dp(self) -> bool:
        """DP-SGD (clip/noise on gradients) active."""
        return self.privacy is not None and self.privacy.dp_enabled

    @property
    def _keyed(self) -> bool:
        """The step draws random numbers (DP-SGD or cut-layer noise)."""
        p = self.privacy
        return p is not None and (p.dp_enabled or p.cut_noise_std > 0)

    def _next_step(self) -> int:
        """The running step index that seeds the step's random streams
        (``privacy.dpsgd.stream_seed``), 1 for the first step."""
        self._key_step += 1
        return self._key_step

    def _take_key_indices(self, count: int) -> np.ndarray:
        """Reserve ``count`` step indices of the same running counter
        ``_next_step`` consumes: the compiled engine seeds step ``i``'s
        draws from the i-th of them, so both engines draw the same
        noise."""
        start = self._key_step
        self._key_step += count
        return np.arange(start + 1, start + count + 1, dtype=np.int64)

    def _cut_specs(self, batch: dict, batch_size: int):
        """The boundary trees a step crosses (front->middle, and
        middle->tail under NLS), as meta tensors at the padded batch length
        ``batch_size`` whatever ``batch``'s own: the shapes the cut noise is
        drawn at (``privacy.dpsgd``, "Batch length"); None without cut
        noise."""
        if self.privacy.cut_noise_std <= 0:
            return None
        key = (batch_size, *((k, tuple(v.shape[1:]), str(v.dtype))
                             for k, v in sorted(batch.items())))
        if key not in self._spec_cache:
            full = {k: as_meta(v).new_empty((batch_size, *v.shape[1:]))
                    for k, v in batch.items()}
            self._spec_cache[key] = list(
                self.adapter.boundary_specs(full).values())
        return self._spec_cache[key]

    def _draws(self, step: int, hospital: int, batch: dict, batch_size: int,
               dp_spec, device=None) -> dict:
        """One hospital's noise for one step (``privacy.dpsgd.
        hospital_draws``), seeded by the running step index ``step``: the
        cut noise drawn at ``batch_size`` rows and cut to ``batch``'s (a
        short remainder batch takes the first rows), the DP noise of
        ``dp_spec``'s shapes (the tree the DP step differentiates), on
        ``device`` (a placed chunk's; the strategy's by default)."""
        d = hospital_draws(self.privacy, step, hospital,
                           self._cut_specs(batch, batch_size), dp_spec,
                           device or self.device)
        rows = len(next(iter(batch.values())))
        return d if rows == batch_size else first_rows(d, rows)

    def _program_draw(self, packed, dp_spec, hospital=None, device=None):
        """The ``draw(key_index, row)`` a keyed compiled program fills its
        noise buffers with before each step (None unkeyed): ``_draws`` for
        the hospital the host row of the step table names (``row[1]``,
        the GLOBAL hospital id, also under participation and placement: a
        hospital's draws never depend on who else was sampled or where it
        lives), or ``hospital``, at the packed batch length, on
        ``device``."""
        if not self._keyed:
            return None
        example = {k: v[0, 0] for k, v in packed.batches.items()}

        def draw(i, row):
            return self._draws(i, int(row[1]) if hospital is None
                               else hospital, example, packed.batch_size,
                               dp_spec, device)
        return draw

    def _dp_account(self, client_idx, n_samples, batch_size, count=1,
                    q_scale=1.0):
        """Record ``count`` DP mechanism applications on hospital
        ``client_idx``'s data (sampling rate batch_size / n_samples).

        ``q_scale`` composes per-round client subsampling with the batch
        rate: under ``Participation`` a hospital takes part in a round with
        probability K/N (or q), so each round's mechanisms touch any one
        example with probability ``q_round * q_batch``, the amplified rate
        the subsampled-Gaussian RDP bound composes at."""
        if not self._dp:
            return
        if self._accountants is None:
            from repro_torch.privacy.accountant import RDPAccountant
            self._accountants = [
                RDPAccountant(self.privacy.noise_multiplier,
                              self.privacy.delta)
                for _ in range(self.n_clients)]
        q = min(batch_size / max(n_samples, 1), 1.0) * q_scale
        self._accountants[client_idx].step(q, count)

    def privacy_report(self) -> list:
        """Per-hospital accountant summaries ((eps, delta) each)."""
        if self._accountants is None:
            return []
        return [a.summary() for a in self._accountants]

    # -- common ---------------------------------------------------------------
    def to_device(self, batch: dict) -> dict:
        """numpy batch -> tensors on the strategy's device (only the keys
        the adapter reads)."""
        keys = self.adapter.batch_keys or tuple(batch)
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(
            self.device) for k in keys}

    def scores(self, state, client_idx, data, batch_size=60,
               chunk_batches=None):
        """Per-sample scores for EVERY sample of one hospital, on
        ``partition.grid_scores``' pad-and-slice grid (the function
        ``ServableModel.scores`` calls: an export scores bit for bit as
        its strategy); ``chunk_batches`` caps the batches moved to the
        device at once."""
        return grid_scores(self.adapter,
                           self.params_for_eval(state, client_idx), data,
                           batch_size, chunk_batches)

    def scores_all(self, state, datas: list, batch_size=60,
                   chunk_batches=None):
        """Per-sample scores of every hospital, each by its own segments
        (under an enabled placement on its chunk's device)."""
        if self.placement.enabled and len(datas) == self.n_clients:
            from repro_torch.core.strategies.placed import scores_all
            return scores_all(self, state, datas, batch_size, chunk_batches)
        return [self.scores(state, i, d, batch_size, chunk_batches)
                for i, d in enumerate(datas)]

    # -- deployment (repro_torch.serving) ------------------------------------
    def export(self, state, client_idx: int = 0, meta: dict | None = None):
        """The deployable full model as a ``serving.ServableModel``: a
        snapshot (clones on the strategy's device) of ``params_for_eval``,
        hospital ``client_idx``'s client segment(s) stitched with the
        server segment (centralized and FL: the one global tree), so its
        ``scores`` equal this strategy's bit for bit."""
        from repro_torch.serving.export import ServableModel
        params = tree_map(lambda t: t.detach().clone(),
                          self.params_for_eval(state, client_idx))
        m = {"strategy": self.name, "client_idx": int(client_idx),
             "n_clients": self.n_clients, **(meta or {})}
        return ServableModel(adapter=self.adapter, params=params,
                             shared=self.shared_eval_params, meta=m)

    def evaluate(self, state, clients, split="test", batch_size=60):
        """Pooled metrics across clients, each scored by its own front."""
        from repro_torch.train import metrics as MET
        datas = [getattr(c, split) for c in clients]
        scores = self.scores_all(state, datas, batch_size)
        all_labels = [d["label"][:len(s)] for d, s in zip(datas, scores)]
        return MET.all_metrics(np.concatenate(all_labels),
                               np.concatenate(scores))

    @torch.no_grad()
    def val_loss(self, state, clients, batch_size=60):
        with self._span("val_loss"):
            losses = []
            for i, c in enumerate(clients):
                params = self.params_for_eval(state, i)
                for b in np_batches(c.val, min(batch_size,
                                               len(c.val["label"])), None):
                    losses.append(self.adapter.full_loss(
                        params, self.to_device(b), train=False))
            if not losses:
                return 0.0
            return sum(torch.stack(losses).cpu().tolist()) / len(losses)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def _grad_trees(loss, *trees):
    """d loss / d every leaf of each tree, as trees of the same shape."""
    leaves = [tree_leaves(t) for t in trees]
    grads = iter(torch.autograd.grad(loss, [l for ls in leaves for l in ls]))
    return [tree_map(lambda _: next(grads), t) for t in trees]


def _grad_trees_from(out, grad_out, *trees):
    """The backward of ``out`` seeded with ``grad_out`` (a tree of its
    shapes): the gradient at every leaf of each tree, as trees."""
    leaves = [tree_leaves(t) for t in trees]
    grads = iter(torch.autograd.grad(tree_leaves(out),
                                     [l for ls in leaves for l in ls],
                                     grad_outputs=tree_leaves(grad_out)))
    return [tree_map(lambda _: next(grads), t) for t in trees]


def _client_params(adapter, cp, sp):
    """A hospital's client tree (front, and tail under NLS) and the server
    segment as one param dict."""
    params = {"front": cp["front"], "middle": sp}
    if adapter.nls:
        params["tail"] = cp["tail"]
    return params


class _Taps:
    """Which metric taps one observed step function computes: the static
    key set of ``telemetry.step_keys`` (None: the step is unobserved and
    returns no metric dict)."""

    def __init__(self, telemetry, dp: bool, cut: bool):
        self.on = telemetry is not None
        keys = telemetry.step_keys(dp=dp, cut=cut) if self.on else ()
        self.norms = "grad_norm" in keys
        self.cut = "cut_mean" in keys
        self.clip = "clip_frac" in keys

    def boundary(self, hook, sink):
        """``hook`` recording every crossing into ``sink`` when the cut
        statistics are on (``telemetry.observing_boundary``)."""
        return T.observing_boundary(hook, sink) if self.cut else hook


def _norm_taps(met, sq_grads, sq_updates):
    met["grad_norm"] = sq_grads.sqrt()
    met["update_norm"] = sq_updates.sqrt()


def full_step_fn(adapter: SplitAdapter, opt: Optimizer, privacy=None,
                 telemetry=None):
    """Step over ALL segments jointly (centralized, FL local training):
    ``step(params, opt_state, batch, weights=None, draws=None) -> (params,
    opt_state, loss)``, the loss detached; ``weights`` (B,) masks the
    padding rows of a pad-and-mask remainder batch out of the loss.

    With DP-SGD (``privacy.dp_enabled``) the gradient is
    ``privacy.dpsgd``'s estimator over the per-example gradients of the
    whole model (K5/K6 for the clip), ``weights`` weighting the examples
    inside it, and ``draws`` is the step's ``hospital_draws`` (its ``"dp"``
    tree the pre-drawn gradient noise).

    With a ``telemetry`` spec (``obs.Telemetry``) the step returns one
    extra trailing dict of 0-d f32 metric taps (the keys of
    ``telemetry.step_keys(dp, cut=False)``) computed from intermediates
    the step already has: the gradient and update norms, and under DP the
    clip fraction of K5's per-example norms.  The taps draw nothing and
    write nothing the step reads, so params stay bit-equal to the
    unobserved step's."""
    dp = privacy is not None and privacy.dp_enabled
    taps = _Taps(telemetry, dp, cut=False)

    def finish(params, opt_state, g, loss, norms=None, weights=None):
        updates, opt_state = opt.update(g, opt_state, params)
        out = (apply_updates(params, updates), opt_state, loss.detach())
        if not taps.on:
            return out
        met = {}
        if taps.norms:
            _norm_taps(met, *T.sq_norms(g, updates))
        if taps.clip:
            met["clip_frac"] = T.clip_fraction(norms, privacy.clip_norm,
                                               weights)
        return out + (met,)

    if not dp:
        def step(params, opt_state, batch, weights=None, draws=None):
            p = detached(params, True)
            loss = adapter.full_loss(p, batch, weights=weights)
            g, = _grad_trees(loss, p)
            return finish(params, opt_state, g, loss)
        return step

    vg = dp_value_and_grad(lambda p, b, e: adapter.full_loss(p, b), privacy,
                           with_norms=taps.clip)

    def dp_step(params, opt_state, batch, weights=None, draws=None):
        out = vg(params, batch, noise=draws and draws["dp"],
                 weights=weights)
        return finish(params, opt_state, out[1], out[0],
                      out[2]["norms"] if taps.clip else None, weights)
    return dp_step


def split_step_fn(adapter: SplitAdapter, opt_client: Optimizer,
                  opt_server: Optimizer, transport=None, privacy=None,
                  telemetry=None):
    """SL/SFLv2 step: the joint gradient through one hospital's client
    segment(s) and the server (numerically the paper's two-hop backprop;
    the hops are the transfers ``core.comm`` accounts).  With a
    ``transport`` every crossing goes through its codec, so the next
    segment trains on what crossed the wire.

    ``step(client_params, server_params, c_opt, s_opt, batch,
    weights=None, draws=None)`` returns the updated ``(client_params,
    server_params, c_opt, s_opt, loss)``; ``weights`` as in
    ``full_step_fn``, ``draws`` the step's ``hospital_draws``.

    With cut-layer noise every crossing (front->middle, and middle->tail
    under NLS) adds its own draws after the codec (one K4 launch per leaf
    over the fused int8 link).  Without DP-SGD ``weights`` weight both the
    loss and the cut noise (a padded row ships clean); with DP-SGD the
    estimator clips the per-example gradient of the joint ``{"c": client
    tree, "s": server}`` and weights the examples itself, so the boundary
    and the inner loss take no weights (the reference's rule).

    With a ``telemetry`` spec the step returns one extra trailing metric
    dict: the joint gradient and update norms, under DP the clip fraction,
    and the moments of the FIRST crossing's payload (front->middle, the
    cut) exactly as it ships, post-codec and post-noise (under DP each
    example's moments come out of the per-example transform as aux and
    are folded with the weights).
    """
    boundary = transport.boundary if transport is not None else None
    noised = None
    if privacy is not None and privacy.cut_noise_std > 0:
        noised = cut_noise_boundary(
            boundary, transport.fused_codec if transport is not None
            else None)
    dp = privacy is not None and privacy.dp_enabled
    taps = _Taps(telemetry, dp, cut=True)

    def update(client_params, server_params, c_opt, s_opt, gc, gs, loss,
               met):
        cu, c_opt = opt_client.update(gc, c_opt, client_params)
        su, s_opt = opt_server.update(gs, s_opt, server_params)
        out = (apply_updates(client_params, cu),
               apply_updates(server_params, su), c_opt, s_opt,
               loss.detach())
        if not taps.on:
            return out
        if taps.norms:
            sq = T.sq_norms(gc, gs, cu, su)
            _norm_taps(met, sq[0] + sq[1], sq[2] + sq[3])
        return out + (met,)

    if not dp:
        def step(client_params, server_params, c_opt, s_opt, batch,
                 weights=None, draws=None):
            cp = detached(client_params, True)
            sp = detached(server_params, True)
            sink = []
            hook = taps.boundary(crossings(boundary, noised,
                                           draws and draws["cut"], weights),
                                 sink)
            loss = adapter.full_loss(_client_params(adapter, cp, sp), batch,
                                     boundary=hook, weights=weights)
            gc, gs = _grad_trees(loss, cp, sp)
            met = {}
            if taps.cut:
                met.update(T.moments_to_stats(*T.payload_moments(sink[0],
                                                                 weights)))
            return update(client_params, server_params, c_opt, s_opt, gc,
                          gs, loss, met)
        return step

    def loss_fn(both, b, z):
        sink = []
        loss = adapter.full_loss(
            _client_params(adapter, both["c"], both["s"]), b,
            boundary=taps.boundary(crossings(boundary, noised, z), sink))
        if taps.cut:
            return loss, T.payload_moments(sink[0])
        return loss

    vg = dp_value_and_grad(loss_fn, privacy, has_aux=taps.cut,
                           with_norms=taps.clip)

    def dp_step(client_params, server_params, c_opt, s_opt, batch,
                weights=None, draws=None):
        # the hospital's cut noise covers its whole batch and enters the
        # per-example transform as a vmapped input
        out = vg({"c": client_params, "s": server_params}, batch,
                 extra=draws and draws["cut"],
                 noise=draws and draws["dp"], weights=weights)
        loss, g = out[0], out[1]
        met = {}
        if taps.cut:
            met.update(T.moments_to_stats(*T.combine_moments(
                *out[2]["aux"], weights)))
        if taps.clip:
            met["clip_frac"] = T.clip_fraction(out[2]["norms"],
                                               privacy.clip_norm, weights)
        return update(client_params, server_params, c_opt, s_opt, g["c"],
                      g["s"], loss, met)
    return dp_step


def _cat(trees):
    return tree_map(lambda *ls: torch.cat(ls), trees[0], *trees[1:])


def _split(tree, sizes):
    offs = np.cumsum([0, *sizes])
    return [tree_map(lambda t: t[offs[i]:offs[i + 1]], tree)
            for i in range(len(sizes))]


def _stacked_moments(moms):
    """Per-hospital ``(mean, meansq, amax)`` triples -> the cut-stat dict
    of ``(S,)`` tensors."""
    return T.moments_to_stats(*(torch.stack(v) for v in zip(*moms)))


def sflv3_step_fn(adapter: SplitAdapter, opt_client: Optimizer,
                  opt_server: Optimizer, n_clients: int, transport=None,
                  privacy=None, telemetry=None, phases=False):
    """SplitFedv3 step (paper Algorithm 1, batch-synchronous form; the
    reference's ``base.sflv3_step_fn`` without padding rows).

    ``step(clients, server, c_opts, s_opt, batches, draws=None)`` takes
    per-hospital lists of client trees, optimizer states and device
    batches, and with privacy the step's noise, ``privacy.dpsgd.
    step_draws``' list of per-hospital ``{"cut", "dp"}`` trees (``"cut"``
    one tree per crossing; drawn outside, so a captured step reads them
    from static buffers); it returns the updated ``(clients, server,
    c_opts, s_opt, losses)``, ``losses`` a detached (n_clients,) tensor.

    Without DP-SGD each hospital's batch runs through its own front; the
    fronts' outputs are concatenated along the batch axis, so the cut layer
    crosses the transport in ONE launch (with cut-layer noise, each
    hospital's noise is drawn from its own stream and the fused int8 link
    is one K4 launch) and the shared server segment runs once on all
    hospitals' rows (GroupNorm and convs are per example, so this equals
    one server pass per hospital).  Under NLS the server's output crosses
    back the same way, one launch per leaf for all hospitals, and each
    hospital's rows go through its own tail; with cut-layer noise each
    crossing adds every hospital's own draws for it.  The loss is the mean
    over
    hospitals of each hospital's mean loss: its gradient gives the server
    the mean of the per-hospital server gradients, and each client gradient is
    rescaled by ``n_clients`` back to that hospital's own, exactly as the
    reference does.

    With DP-SGD every hospital clips and noises its OWN per-example
    gradients of {client segment, server} (K4 at its boundary, K5/K6 for
    the clip) before the server averages, so each hospital's guarantee
    stands on its own; each client keeps its own private gradient.

    With a ``telemetry`` spec the step returns one extra trailing dict of
    per-hospital ``(n_clients,)`` taps: the cut statistics of the first
    crossing (the joint payload split back into each hospital's rows), the
    joint norms ``sqrt(||client grad||^2 + ||server grad||^2)`` with the
    shared averaged server gradient (under DP each hospital's own private
    joint gradient), the update norms with the shared server update, and
    under DP each hospital's clip fraction.

    ``phases=True`` returns the step cut into the phases a placed run
    (``core/strategies/placed.py``) replays on its devices, with the
    tensors that cross between them: ``_placed_phases`` without DP-SGD,
    ``_placed_dp_phases`` with it.
    """
    boundary = transport.boundary if transport is not None else None
    noised = None
    if privacy is not None and privacy.cut_noise_std > 0:
        noised = cut_noise_boundary(
            boundary, transport.fused_codec if transport is not None
            else None)
    dp = privacy is not None and privacy.dp_enabled
    taps = _Taps(telemetry, dp, cut=True)

    def client_update(clients, c_opts, gcs):
        new_clients, new_c_opts, cus = [], [], []
        for cp, gc, co in zip(clients, gcs, c_opts):
            cu, co = opt_client.update(gc, co, cp)
            new_clients.append(apply_updates(cp, cu))
            new_c_opts.append(co)
            cus.append(cu)
        return new_clients, new_c_opts, cus

    def update(clients, server, c_opts, s_opt, gcs, gs, losses, met,
               server_grads):
        new_clients, new_c_opts, cus = client_update(clients, c_opts, gcs)
        su, s_opt = opt_server.update(gs, s_opt, server)
        out = (new_clients, apply_updates(server, su), new_c_opts, s_opt,
               losses.detach())
        if not taps.on:
            return out
        if taps.norms:
            # one multi-tensor norm over every tree: the hospitals' client
            # grads, the server grad(s), the client updates, the server's
            s, k = len(gcs), len(server_grads)
            sq = T.sq_norms(*gcs, *server_grads, *cus, su)
            _norm_taps(met, sq[:s] + sq[s:s + k],
                       sq[s + k:2 * s + k] + sq[-1])
        return out + (met,)

    def grads_joint(clients, server, batches, draws):
        cps = [detached(cp, True) for cp in clients]
        sp = detached(server, True)
        joint = {k: torch.cat([b[k] for b in batches]) for k in batches[0]}
        fronts = [adapter.apply_seg("front", cp["front"], adapter.inputs(b),
                                    b, True) for cp, b in zip(cps, batches)]
        sizes = [tree_leaves(f)[0].shape[0] for f in fronts]
        hook = crossings(boundary, noised, None if noised is None else [
            _cat([d["cut"][i] for d in draws])
            for i in range(len(draws[0]["cut"]))])
        h = _cat(fronts)
        if hook is not None:
            h = hook(h)
        met = {}
        if taps.cut:
            met.update(_stacked_moments([T.payload_moments(part)
                                         for part in _split(h, sizes)]))
        h = adapter.apply_seg("middle", sp, h, joint, True)
        if adapter.nls:
            if hook is not None:
                h = hook(h)
            outs = [adapter.apply_seg("tail", cp["tail"], o, b, True)
                    for cp, o, b in zip(cps, _split(h, sizes), batches)]
        else:
            outs = _split(h, sizes)
        losses = torch.stack([adapter.loss_from_output(o, b)
                              for o, b in zip(outs, batches)])
        *gcs, gs = _grad_trees(losses.sum() / n_clients, *cps, sp)
        gcs = [tree_map(lambda g: g * n_clients, gc) for gc in gcs]
        return gcs, gs, losses, met, [gs]

    def step_fn(clients, server, c_opts, s_opt, batches, draws=None):
        return update(clients, server, c_opts, s_opt,
                      *grads_joint(clients, server, batches, draws))

    if not dp:
        return (_placed_phases(adapter, n_clients, boundary, noised, taps,
                               opt_server, client_update)
                if phases else step_fn)

    def loss_fn(both, b, z):
        sink = []
        params = _client_params(adapter, both["c"], both["s"])
        loss = adapter.full_loss(
            params, b,
            boundary=taps.boundary(crossings(boundary, noised, z), sink))
        if taps.cut:
            return loss, T.payload_moments(sink[0])
        return loss

    vg = dp_value_and_grad(loss_fn, privacy, has_aux=taps.cut,
                           with_norms=taps.clip)

    def grads_dp(clients, server, batches, draws):
        losses, gcs, gss, moms, clips = [], [], [], [], []
        for cp, b, d in zip(clients, batches, draws):
            # the hospital's cut noise covers its whole batch and enters
            # the per-example transform as a vmapped input
            out = vg({"c": cp, "s": server}, b, extra=d["cut"],
                     noise=d["dp"])
            losses.append(out[0])
            gcs.append(out[1]["c"])
            gss.append(out[1]["s"])
            if taps.cut:
                moms.append(T.combine_moments(*out[2]["aux"]))
            if taps.clip:
                clips.append(T.clip_fraction(out[2]["norms"],
                                             privacy.clip_norm))
        met = {}
        if taps.cut:
            met.update(_stacked_moments(moms))
        if taps.clip:
            met["clip_frac"] = torch.stack(clips)
        return gcs, torch.stack(losses), met, gss

    if phases:
        return _placed_dp_phases(grads_dp, client_update, opt_server, taps)

    def dp_step(clients, server, c_opts, s_opt, batches, draws=None):
        gcs, losses, met, gss = grads_dp(clients, server, batches, draws)
        return update(clients, server, c_opts, s_opt, gcs,
                      server_mean(gss, n_clients), losses, met, gss)

    return dp_step


def server_mean(gss, n_clients: int):
    """The private SFLv3 server gradient: the hospitals' own gradients
    added in hospital order, over ``n_clients``."""
    gs = gss[0]
    for g in gss[1:]:
        gs = tree_map(torch.add, gs, g)
    return tree_map(lambda x: x / n_clients, gs)


def _placed_dp_phases(grads_dp, client_update, opt_server, taps):
    """Private SFLv3 in a placed chunk (``core/strategies/placed.py``): each
    hospital's gradient of {client, server} is its own (per-example clip
    and noise), so a chunk holds a replica of the server and steps its
    hospitals' clients, and the server gradient is ``server_mean`` of every
    REAL hospital's gradient, gathered in hospital order between two
    bodies:

      * ``grads(clients, server, c_opts, batches, draws) -> (clients,
        c_opts, gss, losses, parts)``: the chunk's clients updated, each
        hospital's server gradient ``gss``, and the per-hospital halves of
        the norm taps (``parts``);
      * ``server_step(server, s_opt, gs, parts) -> (server, s_opt, met)``:
        the summed ``gs`` applied to the replica, the taps completed."""
    def grads(clients, server, c_opts, batches, draws=None):
        gcs, losses, met, gss = grads_dp(clients, server, batches, draws)
        new_clients, new_c_opts, cus = client_update(clients, c_opts, gcs)
        if taps.norms:
            s = len(gcs)
            sq = T.sq_norms(*gcs, *gss, *cus)
            met["sq_grad"] = sq[:s] + sq[s:2 * s]
            met["sq_update"] = sq[2 * s:]
        return new_clients, new_c_opts, gss, losses.detach(), met

    def server_step(server, s_opt, gs, parts):
        su, s_opt = opt_server.update(gs, s_opt, server)
        met = {k: v for k, v in parts.items() if not k.startswith("sq_")}
        if taps.norms:
            _norm_taps(met, parts["sq_grad"],
                       parts["sq_update"] + T.sq_norms(su)[0])
        return apply_updates(server, su), s_opt, met
    return types.SimpleNamespace(grads=grads, server_step=server_step)


def _placed_phases(adapter, n_clients, boundary, noised, taps, opt_server,
                   client_update):
    """Non-private SFLv3 with the cut crossing devices (a placed run,
    ``core/strategies/placed.py``): each chunk's device runs its
    hospitals' client segments, ONE server on the first device runs the
    middle on every real hospital's rows in hospital order, exactly the
    joint pass of ``sflv3_step_fn``, so the step computes what the
    unplaced one does.  The activations and their gradients cross between
    the bodies (tensors in hospital order; a chunk's phantom rows ride
    along its own bodies and never reach the server):

      * ``front(clients, batches, draws) -> (h, met)``: the chunk's fronts
        and the link (crossing 0), no autograd; the cut statistics;
      * ``server(server, s_opt, h, batches) -> (server, s_opt, dh,
        losses, sq)`` (LS): the middle and the loss on the joint rows, its
        gradient (``dh`` for the fronts), Adam's update; ``sq`` the
        server's squared gradient and update norms;
      * ``server_fwd(server, h, batches) -> o`` (NLS): the middle alone;
      * ``tail(clients, o, batches, draws) -> (tail grads, do, losses)``
        (NLS): the link back (crossing 1), each hospital's tail and loss;
      * ``server_bwd(server, s_opt, h, do, batches) -> (server, s_opt, dh,
        sq)`` (NLS): the middle again under autograd, its gradient from
        ``do``, Adam's update;
      * ``back(clients, c_opts, batches, draws, dh, tail_grads, sq) ->
        (clients, c_opts, met)``: the fronts and the link again under
        autograd, their gradient from ``dh``, the clients' updates, the
        norm taps completed with the server's ``sq``.

    Client gradients are rescaled by ``n_clients`` as in the joint step."""
    def hook(draws, i):
        return crossings(boundary, noised, None if noised is None else [
            _cat([d["cut"][i] for d in draws])])

    def fronts(cps, batches, draws):
        fs = [adapter.apply_seg("front", cp["front"], adapter.inputs(b), b,
                                True) for cp, b in zip(cps, batches)]
        h, link = _cat(fs), hook(draws, 0)
        return (h if link is None else link(h)), [
            tree_leaves(f)[0].shape[0] for f in fs]

    @torch.no_grad()
    def front(clients, batches, draws=None):
        h, sizes = fronts(clients, batches, draws)
        met = {}
        if taps.cut:
            met.update(_stacked_moments([T.payload_moments(part)
                                         for part in _split(h, sizes)]))
        return h, met

    def middle(sp, h, batches):
        joint = {k: torch.cat([b[k] for b in batches]) for k in batches[0]}
        return adapter.apply_seg("middle", sp, h, joint, True)

    def finish(server, s_opt, gs):
        su, s_opt = opt_server.update(gs, s_opt, server)
        sq = T.sq_norms(gs, su) if taps.norms else None
        return apply_updates(server, su), s_opt, sq

    def server(server, s_opt, h, batches):
        sp, hh = detached(server, True), detached(h, True)
        sizes = [len(next(iter(b.values()))) for b in batches]
        losses = torch.stack([adapter.loss_from_output(o, b) for o, b in zip(
            _split(middle(sp, hh, batches), sizes), batches)])
        gs, dh = _grad_trees(losses.sum() / n_clients, sp, hh)
        new, s_opt, sq = finish(server, s_opt, gs)
        return new, s_opt, dh, losses.detach(), sq

    @torch.no_grad()
    def server_fwd(server, h, batches):
        return middle(server, h, batches)

    def tail(clients, o, batches, draws=None):
        oo = detached(o, True)
        tails = [detached(cp["tail"], True) for cp in clients]
        link = hook(draws, 1)
        x = oo if link is None else link(oo)
        sizes = [len(next(iter(b.values()))) for b in batches]
        losses = torch.stack([
            adapter.loss_from_output(adapter.apply_seg("tail", t, part, b,
                                                       True), b)
            for t, part, b in zip(tails, _split(x, sizes), batches)])
        *gts, do = _grad_trees(losses.sum() / n_clients, *tails, oo)
        return ([tree_map(lambda g: g * n_clients, g) for g in gts], do,
                losses.detach())

    def server_bwd(server, s_opt, h, do, batches):
        sp = detached(server, True)
        hh = detached(h, True)
        gs, dh = _grad_trees_from(middle(sp, hh, batches), do, sp, hh)
        new, s_opt, sq = finish(server, s_opt, gs)
        return new, s_opt, dh, sq

    def back(clients, c_opts, batches, draws, dh, tail_grads=None,
             sq_server=None):
        cps = [detached(cp, True) for cp in clients]
        h, _ = fronts(cps, batches, draws)
        gfs = _grad_trees_from(h, dh, *[cp["front"] for cp in cps])
        gcs = [{"front": tree_map(lambda g: g * n_clients, gf)}
               for gf in gfs]
        if tail_grads is not None:
            for gc, gt in zip(gcs, tail_grads):
                gc["tail"] = gt
        new_clients, new_c_opts, cus = client_update(clients, c_opts, gcs)
        met = {}
        if taps.norms:
            s = len(gcs)
            sq = T.sq_norms(*gcs, *cus)
            _norm_taps(met, sq[:s] + sq_server[0], sq[s:] + sq_server[1])
        return new_clients, new_c_opts, met
    return types.SimpleNamespace(front=front, server=server,
                                 server_fwd=server_fwd, tail=tail,
                                 server_bwd=server_bwd, back=back)


__all__ = ["Strategy", "EpochLog", "np_batches", "full_step_fn",
           "split_step_fn", "sflv3_step_fn"]
