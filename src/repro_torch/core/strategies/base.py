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

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.participation import Participation, as_participation
from repro_torch.core.partition import (SplitAdapter, as_meta, detached,
                                        grid_scores)
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
    each hospital (masked padding steps excluded)."""
    losses: list
    steps: int
    weights: list | None = None
    client_steps: list[int] | None = None

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

    def __init__(self, adapter: SplitAdapter, opt_factory: Callable[[], Optimizer],
                 n_clients: int, device: torch.device, privacy=None,
                 engine: str = "compiled", drop_remainder: bool = True,
                 participation=None):
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
        # the compiled engine's programs, one per packed layout
        self._programs: dict = {}

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

    def _check_capturable(self):
        """The compiled engine replays captured steps: an optimizer whose
        state a graph cannot replay (``optim.add_noise``'s generator would
        add the same noise every replay) is refused, never run frozen."""
        if not self.opt_factory().capturable:
            raise NotImplementedError(
                "this optimizer keeps a torch.Generator in its state "
                "(optim.add_noise), which a captured CUDA graph would replay "
                "with the same draws every step; the compiled engine does "
                "not register generator states yet: use engine='stepwise'")

    def _run_epoch_compiled(self, state, client_data, rng, batch_size):
        self._check_capturable()
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
        returns no logs)."""
        if observe is not None:
            raise NotImplementedError("observe= is not ported yet: ROADMAP "
                                      "M10 (observability)")
        if n_epochs <= 0:
            return state, []
        if self.engine == "compiled":
            self._check_capturable()
            out = self._run_compiled(state, client_data, rng, batch_size,
                                     n_epochs, self.participation)
            if out is not None:
                return out
            if self.participation is not None:
                return state, []
        logs = []
        for _ in range(n_epochs):
            state, log = self.run_epoch(state, client_data, rng, batch_size)
            logs.append(log)
        return state, logs

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
               dp_spec) -> dict:
        """One hospital's noise for one step (``privacy.dpsgd.
        hospital_draws``), seeded by the running step index ``step``: the
        cut noise drawn at ``batch_size`` rows and cut to ``batch``'s (a
        short remainder batch takes the first rows), the DP noise of
        ``dp_spec``'s shapes (the tree the DP step differentiates)."""
        d = hospital_draws(self.privacy, step, hospital,
                           self._cut_specs(batch, batch_size), dp_spec,
                           self.device)
        rows = len(next(iter(batch.values())))
        return d if rows == batch_size else first_rows(d, rows)

    def _program_draw(self, packed, dp_spec, hospital=None):
        """The ``draw(key_index, row)`` a keyed compiled program fills its
        noise buffers with before each step (None unkeyed): ``_draws`` for
        the hospital the host row of the step table names (``row[1]``,
        the GLOBAL hospital id, also under participation: a hospital's
        draws never depend on who else was sampled), or ``hospital``, at
        the packed batch length."""
        if not self._keyed:
            return None
        example = {k: v[0, 0] for k, v in packed.batches.items()}

        def draw(i, row):
            return self._draws(i, int(row[1]) if hospital is None
                               else hospital, example, packed.batch_size,
                               dp_spec)
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
        """Per-sample scores of every hospital, each by its own segments."""
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
        losses = []
        for i, c in enumerate(clients):
            params = self.params_for_eval(state, i)
            for b in np_batches(c.val, min(batch_size, len(c.val["label"])),
                                None):
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


def _client_params(adapter, cp, sp):
    """A hospital's client tree (front, and tail under NLS) and the server
    segment as one param dict."""
    params = {"front": cp["front"], "middle": sp}
    if adapter.nls:
        params["tail"] = cp["tail"]
    return params


def full_step_fn(adapter: SplitAdapter, opt: Optimizer, privacy=None):
    """Step over ALL segments jointly (centralized, FL local training):
    ``step(params, opt_state, batch, weights=None, draws=None) -> (params,
    opt_state, loss)``, the loss detached; ``weights`` (B,) masks the
    padding rows of a pad-and-mask remainder batch out of the loss.

    With DP-SGD (``privacy.dp_enabled``) the gradient is
    ``privacy.dpsgd``'s estimator over the per-example gradients of the
    whole model (K5/K6 for the clip), ``weights`` weighting the examples
    inside it, and ``draws`` is the step's ``hospital_draws`` (its ``"dp"``
    tree the pre-drawn gradient noise)."""
    if privacy is None or not privacy.dp_enabled:
        def step(params, opt_state, batch, weights=None, draws=None):
            p = detached(params, True)
            loss = adapter.full_loss(p, batch, weights=weights)
            g, = _grad_trees(loss, p)
            updates, opt_state = opt.update(g, opt_state, params)
            return apply_updates(params, updates), opt_state, loss.detach()
        return step

    vg = dp_value_and_grad(lambda p, b, e: adapter.full_loss(p, b), privacy)

    def dp_step(params, opt_state, batch, weights=None, draws=None):
        loss, g = vg(params, batch, noise=draws and draws["dp"],
                     weights=weights)
        updates, opt_state = opt.update(g, opt_state, params)
        return apply_updates(params, updates), opt_state, loss.detach()
    return dp_step


def split_step_fn(adapter: SplitAdapter, opt_client: Optimizer,
                  opt_server: Optimizer, transport=None, privacy=None):
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
    """
    boundary = transport.boundary if transport is not None else None
    noised = None
    if privacy is not None and privacy.cut_noise_std > 0:
        noised = cut_noise_boundary(
            boundary, transport.fused_codec if transport is not None
            else None)

    def update(client_params, server_params, c_opt, s_opt, gc, gs, loss):
        cu, c_opt = opt_client.update(gc, c_opt, client_params)
        su, s_opt = opt_server.update(gs, s_opt, server_params)
        return (apply_updates(client_params, cu),
                apply_updates(server_params, su), c_opt, s_opt,
                loss.detach())

    if privacy is None or not privacy.dp_enabled:
        def step(client_params, server_params, c_opt, s_opt, batch,
                 weights=None, draws=None):
            cp = detached(client_params, True)
            sp = detached(server_params, True)
            hook = crossings(boundary, noised, draws and draws["cut"],
                             weights)
            loss = adapter.full_loss(_client_params(adapter, cp, sp), batch,
                                     boundary=hook, weights=weights)
            gc, gs = _grad_trees(loss, cp, sp)
            return update(client_params, server_params, c_opt, s_opt, gc,
                          gs, loss)
        return step

    def loss_fn(both, b, z):
        return adapter.full_loss(_client_params(adapter, both["c"],
                                                both["s"]), b,
                                 boundary=crossings(boundary, noised, z))

    vg = dp_value_and_grad(loss_fn, privacy)

    def dp_step(client_params, server_params, c_opt, s_opt, batch,
                weights=None, draws=None):
        # the hospital's cut noise covers its whole batch and enters the
        # per-example transform as a vmapped input
        loss, g = vg({"c": client_params, "s": server_params}, batch,
                     extra=draws and draws["cut"],
                     noise=draws and draws["dp"], weights=weights)
        return update(client_params, server_params, c_opt, s_opt, g["c"],
                      g["s"], loss)
    return dp_step


def _cat(trees):
    return tree_map(lambda *ls: torch.cat(ls), trees[0], *trees[1:])


def _split(tree, sizes):
    offs = np.cumsum([0, *sizes])
    return [tree_map(lambda t: t[offs[i]:offs[i + 1]], tree)
            for i in range(len(sizes))]


def sflv3_step_fn(adapter: SplitAdapter, opt_client: Optimizer,
                  opt_server: Optimizer, n_clients: int, transport=None,
                  privacy=None):
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
    """
    boundary = transport.boundary if transport is not None else None
    noised = None
    if privacy is not None and privacy.cut_noise_std > 0:
        noised = cut_noise_boundary(
            boundary, transport.fused_codec if transport is not None
            else None)

    def update(clients, server, c_opts, s_opt, gcs, gs, losses):
        new_clients, new_c_opts = [], []
        for cp, gc, co in zip(clients, gcs, c_opts):
            cu, co = opt_client.update(gc, co, cp)
            new_clients.append(apply_updates(cp, cu))
            new_c_opts.append(co)
        su, s_opt = opt_server.update(gs, s_opt, server)
        return (new_clients, apply_updates(server, su), new_c_opts, s_opt,
                losses.detach())

    def step_fn(clients, server, c_opts, s_opt, batches, draws=None):
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
        return update(clients, server, c_opts, s_opt, gcs, gs, losses)

    if privacy is None or not privacy.dp_enabled:
        return step_fn

    def loss_fn(both, b, z):
        params = _client_params(adapter, both["c"], both["s"])
        return adapter.full_loss(params, b,
                                 boundary=crossings(boundary, noised, z))

    vg = dp_value_and_grad(loss_fn, privacy)

    def dp_step(clients, server, c_opts, s_opt, batches, draws=None):
        losses, gcs, gs = [], [], None
        for cp, b, d in zip(clients, batches, draws):
            # the hospital's cut noise covers its whole batch and enters
            # the per-example transform as a vmapped input
            loss, g = vg({"c": cp, "s": server}, b, extra=d["cut"],
                         noise=d["dp"])
            losses.append(loss)
            gcs.append(g["c"])
            gs = g["s"] if gs is None else tree_map(torch.add, gs, g["s"])
        gs = tree_map(lambda x: x / n_clients, gs)
        return update(clients, server, c_opts, s_opt, gcs, gs,
                      torch.stack(losses))

    return dp_step


__all__ = ["Strategy", "EpochLog", "np_batches", "full_step_fn",
           "split_step_fn", "sflv3_step_fn"]
