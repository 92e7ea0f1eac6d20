"""In-program telemetry — metric taps inside the captured training step
(counterpart of ``repro/obs/telemetry.py``).

The compiled engine (``core/strategies/engine.py``) replays one captured
CUDA graph per step, and a replay gives the host nothing back but what its
static buffers hold.  ``Telemetry`` is the spec of what else to observe:
the taps are computed INSIDE the step functions from intermediates the
step already has (gradients, updates, the cut-layer payload as it ships,
the per-example clip norms K5 returns) and written into per-step device
buffers beside the losses:

  * no host read inside a step — an observed run replays exactly as many
    graphs as an unobserved one, and the metrics come back with the
    losses in the run's one readback;
  * pure observation — the taps read detached tensors, draw from no
    generator and write nothing the training math reads, so observed
    params are bit-equal to unobserved ones (on the card under cuDNN's
    deterministic algorithms; with its default ones an observed run
    differs from an unobserved one only as two unobserved runs do);
  * few launches — norms are one multi-tensor ``torch._foreach_norm``
    over all leaves, and the cut statistics are per-leaf f32 sums, never a
    concatenated copy of the payload.

Metric taps (each gated by a ``Telemetry`` flag AND by availability —
cut-layer stats only exist for the SL/SFL family, clip fractions only
under DP-SGD):

  ``loss``           per-round x per-hospital mean train loss
  ``grad_norm``      global L2 of the step gradient
  ``update_norm``    global L2 of the optimizer update actually applied
  ``update_cosine``  FL only: cosine of each hospital's round update to
                     the aggregated update
  ``cut_mean/std/absmax``  moments of the cut-layer payload exactly as it
                     crosses the wire (post-codec, post-noise)
  ``clip_frac``      DP-SGD: fraction of examples whose per-example grad
                     was clipped
  ``epsilon``        per-round cumulative RDP epsilon per hospital
                     (composed on the host from the same counts the real
                     accountant uses)

The host-side half (``RoundTelemetry`` ... ``epsilon_rounds``) is the
reference's numpy code, the same names and the same output bit for bit:
both engines reduce their per-step stacks through it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """Spec of in-program metric taps for one observed run.

    Flags select taps; a tap that does not apply to the strategy at hand
    (cut stats without a cut layer, clip fractions without DP) is simply
    absent from the output.  ``Telemetry()`` enables everything.
    """
    loss: bool = True
    norms: bool = True            # grad_norm + update_norm
    update_cosine: bool = True    # FL: per-round cosine-to-mean update
    cut_stats: bool = True        # SL/SFL: cut payload mean/std/absmax
    clip_fraction: bool = True    # DP-SGD: fraction of clipped examples
    epsilon: bool = True          # per-round RDP eps per hospital

    @property
    def enabled(self) -> bool:
        return (self.loss or self.norms or self.update_cosine
                or self.cut_stats or self.clip_fraction or self.epsilon)

    def step_keys(self, dp: bool, cut: bool) -> tuple[str, ...]:
        """Static key set of the per-step metric dict a step function
        emits: it fixes the program's metric buffers before capture."""
        keys = []
        if self.norms:
            keys += ["grad_norm", "update_norm"]
        if self.cut_stats and cut:
            keys += ["cut_mean", "cut_std", "cut_absmax"]
        if self.clip_fraction and dp:
            keys += ["clip_frac"]
        return tuple(keys)


def as_telemetry(observe) -> Telemetry | None:
    """Normalize an ``observe=`` argument: None/False off, True -> all
    taps, or a ``Telemetry`` instance."""
    if observe is None or observe is False:
        return None
    if observe is True:
        return Telemetry()
    if not isinstance(observe, Telemetry):
        raise TypeError(f"observe must be a Telemetry, got {observe!r}")
    return observe if observe.enabled else None


# ---------------------------------------------------------------------------
# taps (tensor code; called inside the step functions, so inside a capture)
# ---------------------------------------------------------------------------

def sq_norms(*trees):
    """``(len(trees),)`` f32: each tree's sum of squares over all its
    leaves, from ONE multi-tensor ``torch._foreach_norm`` over the leaves
    of every tree (a few launches for hundreds of leaves)."""
    groups = [[l.detach().float() for l in tree_leaves(t)] for t in trees]
    flat = [l for g in groups for l in g]
    if not flat:
        return torch.zeros((len(trees),))
    sq = torch.stack(torch._foreach_norm(flat)).square()
    return torch.stack([s.sum() for s in sq.split([len(g) for g in groups])])


def global_norm(tree):
    """Global L2 norm over every leaf of a gradient/update tree."""
    return sq_norms(tree)[0].sqrt()


def _example_moments(leaf):
    """Per-example (sum, sum of squares, absmax) of one ``(B, ...)`` leaf,
    each ``(B,)`` f32, reduced over the example's dims in place (no
    flattened or f32 copy of a channels-last payload)."""
    x = leaf.detach()
    if x.dim() == 1:
        x = x.unsqueeze(1)
    dims = tuple(range(1, x.dim()))
    s = x.sum(dim=dims, dtype=torch.float32)
    sq = torch.linalg.vector_norm(x, 2, dim=dims,
                                  dtype=torch.float32).square()
    amax = torch.maximum(x.amax(dim=dims), -x.amin(dim=dims)).float()
    return s, sq, amax


def payload_moments(tree, weights=None):
    """(mean, mean-of-squares, absmax) of a cut-layer payload tree, each a
    0-d f32 tensor.

    Every leaf carries a leading batch axis; ``weights`` is an optional
    (B,) 0/1 validity mask (pad-and-mask rows) — masked examples
    contribute to no moment.  The reference flattens and concatenates the
    payload; here each leaf is reduced per example in f32 and the leaves'
    sums combined, which gives the same moments since every example has
    the same element count.
    """
    leaves = tree_leaves(tree)
    d = sum(l[0].numel() for l in leaves)
    per = [_example_moments(l) for l in leaves]
    s = sum(p[0] for p in per)
    sq = sum(p[1] for p in per)
    amax = torch.stack([p[2] for p in per]).amax(0)
    if weights is None:
        n = s.shape[0] * d
        return s.sum() / n, sq.sum() / n, amax.amax()
    w = weights.detach().float()
    denom = torch.clamp_min(w.sum(), 1.0) * d
    return ((s * w).sum() / denom, (sq * w).sum() / denom,
            torch.where(w > 0, amax, 0.0).amax())


def combine_moments(mean_b, meansq_b, amax_b, weights=None):
    """Fold per-example moments ``[B]`` (the DP path's per-example aux)
    into batch moments — weighted so padded examples vanish."""
    if weights is None:
        return mean_b.mean(), meansq_b.mean(), amax_b.amax()
    w = weights.detach().float()
    denom = torch.clamp_min(w.sum(), 1.0)
    return ((mean_b * w).sum() / denom, (meansq_b * w).sum() / denom,
            torch.where(w > 0, amax_b, 0.0).amax())


def moments_to_stats(mean, meansq, amax) -> dict:
    """Finalize moments into the reported cut-stat metric dict."""
    var = torch.clamp_min(meansq - mean.square(), 0.0)
    return {"cut_mean": mean, "cut_std": var.sqrt(), "cut_absmax": amax}


def clip_fraction(norms, clip_norm, weights=None):
    """Fraction of (valid) examples whose per-example gradient hit the
    clip: ``norm > C`` is exactly when ``clip_scales = min(1, C/norm)``
    bites.  ``norms`` are the (B,) pre-clip norms K5 computes;
    ``weights`` excludes padded rows.  ``clip_norm=inf`` yields 0."""
    clipped = (norms.detach() > clip_norm).float()
    if weights is None:
        return clipped.mean()
    w = weights.detach().float()
    return (clipped * w).sum() / torch.clamp_min(w.sum(), 1.0)


def observing_boundary(base_boundary, sink: list):
    """Wrap a boundary hook so every crossing's payload is recorded into
    ``sink`` exactly as it ships (post-codec, post-noise); ``sink[0]`` is
    the FIRST crossing (front->middle — THE cut layer).  The payload itself
    is returned unchanged, so observation never perturbs training math."""
    def fn(tree):
        out = tree if base_boundary is None else base_boundary(tree)
        sink.append(out)
        return out
    return fn


def update_cosine(stacked, gp, new_gp, eps=1e-12):
    """``(C,)`` cosine between each local FedAvg update delta (``local_c -
    global``) and the aggregated delta (``new_global - global``), the
    round's update-agreement tap; per-leaf f32 dot products, once a round.
    Zero deltas (an empty slot, a no-op round) report cosine 0."""
    ls = tree_leaves(stacked)
    c = ls[0].shape[0]
    num = torch.zeros((c,), device=ls[0].device)
    dsq = torch.zeros((c,), device=ls[0].device)
    msq = torch.zeros((), device=ls[0].device)
    for l, g, n in zip(ls, tree_leaves(gp), tree_leaves(new_gp)):
        g = g.detach().float().reshape(-1)
        d = l.detach().float().reshape(c, -1) - g
        m = n.detach().float().reshape(-1) - g
        num = num + d @ m
        dsq = dsq + d.square().sum(1)
        msq = msq + m @ m
    return num / (dsq.sqrt() * msq.sqrt() + eps)


# ---------------------------------------------------------------------------
# host-side reductions — per-step stacks -> per-round x per-hospital
# ---------------------------------------------------------------------------

def _nanrow(n):
    return np.full((n,), np.nan)


def _masked_client_mean(arr, mask, n_clients) -> np.ndarray:
    """``[C, NB]`` values + validity mask -> per-hospital mean ``[C_real]``
    (phantom/padded rows sliced off)."""
    a = np.asarray(arr, np.float64)[:n_clients]
    m = np.asarray(mask, np.float64)[:n_clients]
    s, c = (a * m).sum(axis=1), m.sum(axis=1)
    with np.errstate(invalid="ignore"):
        return np.where(c > 0, s / np.maximum(c, 1.0), np.nan)


def _scheduled_client_mean(arr, sched, n_clients) -> np.ndarray:
    """``[S]`` per-step values in schedule order -> per-hospital mean."""
    a = np.asarray(arr, np.float64)
    out, cnt = np.zeros(n_clients), np.zeros(n_clients)
    for v, (c, _b) in zip(a, np.asarray(sched)):
        if c < n_clients:
            out[c] += v
            cnt[c] += 1
    with np.errstate(invalid="ignore"):
        return np.where(cnt > 0, out / np.maximum(cnt, 1.0), np.nan)


@dataclasses.dataclass
class RoundTelemetry:
    """One training round's reduced metrics: every value is a
    ``[n_clients]`` float array (NaN where a hospital took no step).

    Under per-round client subsampling ``participation`` lists the
    round's sampled GLOBAL hospital ids; metric columns of unsampled
    hospitals are NaN for that round."""
    round_index: int
    metrics: dict
    epsilon: np.ndarray | None = None
    participation: np.ndarray | None = None

    def scalars(self) -> dict:
        """Hospital-mean summary of each metric (for printing)."""
        out = {}
        for k, v in self.metrics.items():
            with np.errstate(invalid="ignore"):
                out[k] = float(np.nanmean(v)) if np.asarray(v).size else float("nan")
        if self.epsilon is not None:
            out["epsilon_max"] = float(np.max(self.epsilon))
        return out

    def to_json(self) -> dict:
        out = {"round": self.round_index,
               "metrics": {k: np.asarray(v, np.float64).tolist()
                           for k, v in self.metrics.items()}}
        if self.epsilon is not None:
            out["epsilon"] = np.asarray(self.epsilon, np.float64).tolist()
        if self.participation is not None:
            out["participation"] = [
                int(i) for i in np.asarray(self.participation)]
        return out


@dataclasses.dataclass
class RunTelemetry:
    """Whole observed run: one ``RoundTelemetry`` per round."""
    strategy: str
    n_clients: int
    rounds: list

    def metric(self, name: str) -> np.ndarray:
        """``[n_rounds, n_clients]`` stack of one metric across rounds."""
        return np.stack([r.metrics.get(name, _nanrow(self.n_clients))
                         for r in self.rounds])

    def to_json(self) -> dict:
        return {"strategy": self.strategy, "n_clients": self.n_clients,
                "rounds": [r.to_json() for r in self.rounds]}

    def table(self) -> str:
        """Markdown per-round summary table."""
        if not self.rounds:
            return "(no rounds observed)"
        keys = sorted({k for r in self.rounds for k in r.scalars()})
        lines = ["| round | " + " | ".join(keys) + " |",
                 "|---" * (len(keys) + 1) + "|"]
        for r in self.rounds:
            s = r.scalars()
            lines.append("| " + " | ".join(
                [str(r.round_index)]
                + [f"{s[k]:.4g}" if k in s and np.isfinite(s[k]) else "-"
                   for k in keys]) + " |")
        return "\n".join(lines)


def _per_metric(tel: Telemetry, loss, metrics: dict, reduce) -> dict:
    out = {}
    if tel.loss:
        out["loss"] = reduce(loss)
    for k, v in metrics.items():
        out[k] = reduce(v)
    return out


def rounds_client_major(tel: Telemetry, losses, metrics: dict, mask,
                        n_clients: int, extra: dict | None = None) -> list:
    """Reduce FL/centralized stacks ``[E, C, NB]`` (+ per-round ``extra``
    taps ``[E, C]``, e.g. the FedAvg update cosine) into per-round
    telemetry."""
    losses = np.asarray(losses)
    E = losses.shape[0]
    out = []
    for e in range(E):
        m = _per_metric(tel, losses[e],
                        {k: np.asarray(v)[e] for k, v in metrics.items()},
                        lambda a: _masked_client_mean(a, mask, n_clients))
        for k, v in (extra or {}).items():
            m[k] = np.asarray(v, np.float64)[e][:n_clients]
        out.append(RoundTelemetry(e, m))
    return out


def rounds_participation(tel: Telemetry, losses, metrics: dict, pack,
                         extra: dict | None = None) -> list:
    """Reduce a participating FL run's SLOT-major stacks ``[E, S, NB]``
    (+ per-round ``extra`` taps ``[E, S]``) into per-round telemetry over
    the GLOBAL hospital axis: each slot's per-round mean scatters to its
    global hospital's column, hospitals not sampled that round are NaN,
    and ``RoundTelemetry.participation`` records the round's sampled ids.
    """
    losses = np.asarray(losses)
    E, N = losses.shape[0], pack.n_global

    def scatter_slots(e):
        gid = np.asarray(pack.slot_gid[e])

        def reduce(a):
            a = np.asarray(a, np.float64)
            if a.ndim == 2:                       # [S, NB] per-step taps
                row = _masked_client_mean(a, pack.mask[e], a.shape[0])
            else:                                 # [S] per-round taps
                row = a
            out = _nanrow(N)
            for s, g in enumerate(gid):
                if g >= 0 and not np.isnan(row[s]):
                    out[g] = row[s]
            return out
        return reduce

    out = []
    for e in range(E):
        reduce = scatter_slots(e)
        m = _per_metric(tel, losses[e],
                        {k: np.asarray(v)[e] for k, v in metrics.items()},
                        reduce)
        for k, v in (extra or {}).items():
            m[k] = reduce(np.asarray(v, np.float64)[e])
        r = RoundTelemetry(e, m)
        r.participation = np.flatnonzero(np.asarray(pack.part_mask[e]))
        out.append(r)
    return out


def rounds_scheduled(tel: Telemetry, losses, metrics: dict, sched,
                     n_clients: int) -> list:
    """Reduce SL/SFLv2 stacks ``[E, S]`` through the schedule array."""
    losses = np.asarray(losses)
    out = []
    for e in range(losses.shape[0]):
        m = _per_metric(
            tel, losses[e],
            {k: np.asarray(v)[e] for k, v in metrics.items()},
            lambda a: _scheduled_client_mean(a, sched, n_clients))
        out.append(RoundTelemetry(e, m))
    return out


def rounds_sync(tel: Telemetry, losses, metrics: dict,
                n_clients: int) -> list:
    """Reduce SFLv3/v1 stacks ``[E, S, C]`` (every client active every
    synchronous step; placement phantom columns sliced off)."""
    losses = np.asarray(losses)
    out = []
    for e in range(losses.shape[0]):
        m = _per_metric(
            tel, losses[e],
            {k: np.asarray(v)[e] for k, v in metrics.items()},
            lambda a: np.asarray(a, np.float64)[:, :n_clients].mean(axis=0)
            if np.asarray(a).size else _nanrow(n_clients))
        out.append(RoundTelemetry(e, m))
    return out


def pack_client_major(values: list, n_batches: list):
    """Stepwise-engine helper: a client-major flat list of per-step values
    -> (``[C, NB_max]`` array, validity mask) matching the compiled
    layout, so both engines reduce through the same code."""
    C = len(n_batches)
    NB = max(n_batches, default=0)
    arr = np.zeros((C, max(NB, 1)))
    mask = np.zeros((C, max(NB, 1)), bool)
    it = iter(values)
    for c, nb in enumerate(n_batches):
        for b in range(nb):
            arr[c, b] = next(it)
            mask[c, b] = True
    return arr, mask


# ---------------------------------------------------------------------------
# per-round privacy epsilon series
# ---------------------------------------------------------------------------

def epsilon_rounds(privacy, logs, n_samples: list, batch_size: int,
                   pooled: bool = False, q_scale: float = 1.0,
                   steps_override: list | None = None) -> np.ndarray | None:
    """``[n_rounds, n_clients]`` cumulative (eps at delta) after each
    round, composed from the SAME per-round step counts and sampling
    rates the strategies feed the real accountant (``EpochLog.
    client_steps`` / ``steps``), so the last row equals the run's
    ``privacy_report`` epsilons when this run is the only training.

    ``pooled`` is the centralized case: every hospital's records sit in
    the pooled set, so each composes at the pooled sampling rate over the
    pooled step count.

    Under client subsampling (``Participation`` with sampling randomness)
    EVERY hospital composes EVERY round at the amplified rate
    ``q_scale * q_batch`` over the step count it would contribute when
    sampled — pass that count per hospital as ``steps_override`` (the
    realized ``client_steps`` are zero for unsampled rounds and must NOT
    be used, since amplification accounts the sampling probability, not
    the realization).
    """
    if privacy is None or not privacy.dp_enabled:
        return None
    from repro_torch.privacy.accountant import RDPAccountant
    n_clients = len(n_samples)
    n_pool = sum(n_samples)
    accts = [RDPAccountant(privacy.noise_multiplier, privacy.delta)
             for _ in range(n_clients)]
    out = np.zeros((len(logs), n_clients))
    for e, log in enumerate(logs):
        for c in range(n_clients):
            if pooled:
                q, steps = (min(batch_size / max(n_pool, 1), 1.0),
                            log.steps)
            else:
                q = min(batch_size / max(n_samples[c], 1), 1.0)
                if steps_override is not None:
                    steps = steps_override[c]
                else:
                    steps = (log.client_steps[c]
                             if log.client_steps is not None else log.steps)
            accts[c].step(q * q_scale, steps)
            out[e, c] = accts[c].epsilon()[0]
    return out


__all__ = ["Telemetry", "RoundTelemetry", "RunTelemetry", "as_telemetry",
           "sq_norms", "global_norm", "payload_moments", "combine_moments",
           "moments_to_stats", "clip_fraction", "observing_boundary",
           "update_cosine", "rounds_client_major", "rounds_participation",
           "rounds_scheduled", "rounds_sync", "pack_client_major",
           "epsilon_rounds"]
