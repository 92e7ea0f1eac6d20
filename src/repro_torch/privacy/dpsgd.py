"""DP-SGD — per-example clipping + Gaussian noising of gradients, and
Gaussian noise on the cut-layer activations.  Counterpart of
``repro/privacy/dpsgd.py``.

  * **DP-SGD** (``clip_norm``/``noise_multiplier``): per-example gradients
    by ``torch.func.vmap(torch.func.grad_and_value(...))`` over singleton
    sub-batches, clipped and summed by K5/K6 (``kernels/dp_clip``), then
    ``N(0, (sigma*C)^2)`` noise on the SUM before the 1/B mean.  Guarantees
    are per hospital and composed by ``privacy.accountant``.
  * **Cut-layer noise** (``cut_noise_std``): Gaussian noise added to the
    smashed activations after the codec roundtrip; over the fused int8 link
    the roundtrip and the add are one K4 launch.

**Randomness.**  The port cannot reproduce the reference's threefry
``fold_in`` streams and does not try to.  It keeps their structure: every
draw comes from a ``torch.Generator`` on the run's device seeded with
``stream_seed(seed, step, hospital, purpose)``, so a hospital's draws
depend on the privacy seed, the step index, its own index and what they
are for, never on how many hospitals share the step.  The mix is
SplitMix64 (Steele et al. 2014) folded over the four fields in that order:
``h = 0; for v in (seed, step, hospital, purpose): h = splitmix64(h ^ v)``,
kept to 63 bits.  ``purpose`` is 1 for the cut noise and 2 for the
gradient noise.  Every random tensor is drawn OUTSIDE ``torch.func.vmap``
(which refuses random ops): a hospital's cut noise for its whole batch is
drawn first and enters the per-example transform as a vmapped input.

**Batch length.**  The reference keys each example's cut noise by its
position (``fold_in``), so a padded remainder batch noises its real rows
as the short batch does.  A generator's draws depend on how many numbers
are drawn at once (on the card, Philox offsets follow the launch grid), so
the port draws the cut noise at the PADDED batch length always
(``batch_size`` rows): the compiled engine's padded batch uses all of it,
the stepwise engine's short batch its first rows (``first_rows``).  The
gradient noise has the params' shapes and no batch axis.

With ``noise_multiplier=0`` and ``clip_norm=inf`` (``force_dp``) the DP
path reduces to exact per-example-mean gradients — numerically the
non-private step.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.dp_clip.ops import clip_accumulate
from repro_torch.tree import tree_leaves, tree_map

CUT, DP = 1, 2              # the ``purpose`` field of ``stream_seed``
_M64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class PrivacyConfig:
    """Privacy mechanisms for one training run.

    noise_multiplier : sigma of the DP-SGD Gaussian mechanism (noise std is
                       ``sigma * clip_norm`` on the clipped gradient SUM).
    clip_norm        : per-example L2 clip C; ``inf`` disables clipping.
    delta            : target delta for the (eps, delta) report.
    cut_noise_std    : std of Gaussian noise on cut-layer activations
                       (SL/SFL families only; 0 disables).
    secagg           : pairwise-mask secure aggregation for FedAvg uploads
                       (FL only; ``privacy.secagg``).
    seed             : base seed for all privacy randomness.
    force_dp         : run the DP-SGD machinery even with neutral
                       parameters (noise 0 / clip inf) — used to assert the
                       DP path reduces to the non-private step.
    """
    noise_multiplier: float = 0.0
    clip_norm: float = math.inf
    delta: float = 1e-5
    cut_noise_std: float = 0.0
    secagg: bool = False
    seed: int = 0
    force_dp: bool = False

    def __post_init__(self):
        if self.noise_multiplier > 0 and not math.isfinite(self.clip_norm):
            raise ValueError(
                "noise_multiplier > 0 with clip_norm=inf has unbounded "
                "sensitivity — no (eps, delta) statement exists; set a "
                "finite clip_norm")

    @property
    def dp_enabled(self) -> bool:
        return (self.noise_multiplier > 0 or math.isfinite(self.clip_norm)
                or self.force_dp)

    @property
    def any_enabled(self) -> bool:
        return self.dp_enabled or self.cut_noise_std > 0 or self.secagg


# ---------------------------------------------------------------------------
# explicit random streams
# ---------------------------------------------------------------------------

def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def stream_seed(seed: int, step: int, hospital: int, purpose: int) -> int:
    """The 63-bit seed of one (step, hospital, purpose) stream."""
    h = 0
    for v in (seed, step, hospital, purpose):
        h = _splitmix64(h ^ (int(v) & _M64))
    return h >> 1


def make_generator(cfg: PrivacyConfig, step: int, hospital: int,
                   purpose: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(cfg.seed, step, hospital, purpose))
    return gen


# ---------------------------------------------------------------------------
# DP-SGD
# ---------------------------------------------------------------------------

def per_example_grads(loss_fn, params, batch, extra=None, has_aux=False):
    """vmapped (loss, grad) over singleton sub-batches.

    ``loss_fn(params, batch, extra) -> scalar`` must be a per-batch MEAN, so
    a size-1 batch yields that example's own loss and gradient.  ``extra``
    is an optional tree of per-example inputs with a leading B axis (the
    cut noise), split along with the batch.  Returns ((B,) losses, grad tree
    with a leading B axis).  A batch of one example (a remainder batch) is
    its own per-example batch and takes no ``vmap``: PyTorch's vmapped
    ``group_norm`` refuses a channels-last input when the vmapped size is
    one.

    With ``has_aux`` the loss_fn returns ``(loss, aux)``, ``aux`` a tree of
    0-d tensors (the telemetry taps' per-example payload moments), and the
    result is ``((losses, aux stacked to (B,) each), grads)``; the gradient
    computation is the same.
    """
    def one(b, e):
        g, v = torch.func.grad_and_value(loss_fn, has_aux=has_aux)(
            params, b, e)
        return v, g
    if len(tree_leaves(batch)[0]) == 1:
        v, g = one(batch, extra)
        v = tree_map(lambda t: t.reshape(1), v)
        return v, tree_map(lambda t: t.unsqueeze(0), g)
    single = lambda t: t.unsqueeze(1)                       # noqa: E731
    extra = None if extra is None else tree_map(single, extra)
    return torch.func.vmap(one, in_dims=(0, None if extra is None else 0))(
        tree_map(single, batch), extra)


def dp_noise_std(cfg: PrivacyConfig) -> float:
    """The std ``sigma * C`` of the Gaussian noise on the clipped gradient
    sum (0 without noise)."""
    # PrivacyConfig rejects noise > 0 with clip inf (unbounded sensitivity)
    return (float(cfg.noise_multiplier) * float(cfg.clip_norm)
            if cfg.noise_multiplier > 0 else 0.0)


def dp_value_and_grad(loss_fn, cfg: PrivacyConfig, has_aux=False,
                      with_norms=False):
    """DP analogue of ``value_and_grad``.

    ``loss_fn(params, batch, extra) -> scalar``.  Returns ``fn(params,
    batch, gen=None, extra=None, noise=None, weights=None) -> (mean loss,
    noisy clipped mean grad)``: ``(sum_b clip(g_b) + sigma*C*z) / B`` with
    ``z ~ N(0, I)`` — the standard Abadi et al. DP-SGD estimator.  The
    noise is ``noise``, a tree of pre-scaled draws of the params' shapes
    (``draw_noise``: the compiled engine fills it outside its captured
    step), or else drawn here from ``gen``; the same generator gives the
    same noise either way.

    ``weights`` (optional (B,) 0/1, the compiled engine's pad-and-mask
    rows under ``drop_remainder=False``) scales each per-example gradient
    BEFORE the clip, so a padded example adds exactly nothing, and the
    mean divides by ``max(sum(weights), 1)``, the real example count; the
    loss is the weighted mean.  The clip is K5/K6 (``kernels/dp_clip``) on
    the weighted rows; the reference's ``use_kernel`` switch is not
    ported, since a CUDA tensor always launches the kernels.

    Telemetry hooks (both leave the estimator untouched): ``has_aux``
    makes loss_fn return ``(loss, aux)``, each example's aux stacked along
    a leading B axis, and ``with_norms`` exposes the (B,) per-example
    pre-clip gradient norms K5 returns through ``clip_accumulate``.  With
    either set, fn returns ``(loss, grad, extras)``, extras holding
    ``"aux"`` and/or ``"norms"``.
    """
    noise_std = dp_noise_std(cfg)

    def fn(params, batch, gen=None, extra=None, noise=None, weights=None):
        out = per_example_grads(loss_fn, params, batch, extra, has_aux)
        (losses, aux), grads = out if has_aux else ((out[0], None), out[1])
        b = losses.shape[0]
        if weights is None:
            denom, loss = b, losses.mean()
        else:
            w = weights.float()
            grads = tree_map(
                lambda g: g * w.reshape((b,) + (1,) * (g.dim() - 1)), grads)
            denom = torch.clamp_min(w.sum(), 1.0)
            loss = (losses * w).sum() / denom
        summed, norms = clip_accumulate(grads, float(cfg.clip_norm))
        if noise is None and noise_std > 0:
            noise = draw_noise(params, gen, noise_std)
        if noise is not None:
            summed = tree_map(lambda s, z: s + z.to(s.dtype), summed, noise)
        grad = tree_map(lambda s, p: (s / denom).to(p.dtype), summed, params)
        if not (has_aux or with_norms):
            return loss, grad
        extras = {}
        if has_aux:
            extras["aux"] = aux
        if with_norms:
            extras["norms"] = norms
        return loss, grad, extras

    return fn


# ---------------------------------------------------------------------------
# cut-layer noise
# ---------------------------------------------------------------------------

def _leaf_noise(l, gen: torch.Generator, std: float):
    """std-scaled f32 Gaussian draws of ``l``'s shape from ``gen`` (on its
    device) — the ONE noise draw the fused and unfused paths both
    consume."""
    return std * torch.randn(l.shape, generator=gen, device=gen.device)


def draw_noise(tree, gen: torch.Generator, std: float):
    """Pre-scaled noise for every leaf of a tree (a boundary's or the
    params', real or meta tensors), drawn in leaf order from ``gen``."""
    return tree_map(lambda l: _leaf_noise(l, gen, std), tree)


def hospital_draws(cfg: PrivacyConfig, step: int, hospital: int,
                   cut_specs, dp_spec, device) -> dict:
    """One hospital's noise for one step, ``step`` the running index that
    seeds its streams: ``{"cut": [draws of each crossing's spec, in
    crossing order] or None, "dp": draws of dp_spec's shapes or None}``.
    ``cut_specs`` lists the boundary trees a step crosses (``partition.
    boundary_specs``' values: front->middle, and middle->tail under NLS) at
    the padded batch length; the crossings draw one after another from the
    hospital's cut stream, so each has its own draws.  ``dp_spec`` is the
    tree DP-SGD differentiates (the params of centralized and FL, ``{"c":
    client tree, "s": server}`` of the split family).  Both engines draw
    with this before a step: the stepwise one passes the draws to its step,
    the compiled one copies them into its static buffers before a
    replay."""
    dp_std = dp_noise_std(cfg) if cfg.dp_enabled else 0.0
    d = {"cut": None, "dp": None}
    if cfg.cut_noise_std > 0:
        d["cut"] = draw_noise(
            list(cut_specs), make_generator(cfg, step, hospital, CUT, device),
            cfg.cut_noise_std)
    if dp_std > 0:
        d["dp"] = draw_noise(
            dp_spec, make_generator(cfg, step, hospital, DP, device), dp_std)
    return d


def step_draws(cfg: PrivacyConfig, step: int, hospitals, cut_specs,
               dp_specs, device) -> list:
    """The noise of one SFLv3 step for each hospital id of ``hospitals``
    (``hospital_draws`` for each, in order; ``dp_specs[j]`` is the j-th's
    ``{"c", "s"}`` tree).  Under participation the ids are the round's
    sampled GLOBAL hospitals, so a hospital draws the same noise whoever
    else was sampled."""
    return [hospital_draws(cfg, step, int(c), cut_specs, dp_specs[j], device)
            for j, c in enumerate(hospitals)]


def first_rows(draws: dict, rows: int) -> dict:
    """A hospital's draws (drawn at the padded batch length) cut to the
    first ``rows`` examples: the stepwise engine's short remainder batch
    takes exactly the noise the compiled engine's padded batch puts on its
    real rows."""
    if draws["cut"] is None:
        return draws
    return {**draws, "cut": tree_map(lambda z: z[:rows], draws["cut"])}


def cut_noise_boundary(base_boundary, codec=None):
    """Wrap a transport boundary fn with additive Gaussian cut-layer noise.

    Returns ``fn(tree, noise, weights=None)``, ``noise`` the tree of
    pre-scaled draws (``draw_noise``); the noise rides AFTER the codec
    roundtrip — the client adds it to exactly what ships (the reference
    draws inside and takes the std here; the port's draws come pre-scaled
    because ``vmap`` refuses random ops).  ``weights`` (optional (B,) 0/1,
    the compiled engine's pad-and-mask rows) multiplies each example's
    noise: a padded row gets none, so the shipped payload stays clean
    there.

    With a fusable ``codec`` (``Int8Codec``) the roundtrip AND the add are
    ONE K4 launch per leaf, its row weight the example's weight repeated
    over the example's rows, in the same f32 op order as the unfused
    composition (the noise times its weight, rounded to the activation's
    dtype, then the add), so fused == unfused bitwise; ``base_boundary`` is
    then skipped.
    """
    fused_rt = getattr(codec, "fused_noise_roundtrip", None)

    def one(l, z, weights):
        if fused_rt is not None:
            return fused_rt(l, z, weights)
        if weights is not None:
            z = z * weights.float().reshape(
                (l.shape[0],) + (1,) * (l.dim() - 1))
        return l + z.to(l.dtype)

    def fn(tree, noise, weights=None):
        if fused_rt is None and base_boundary is not None:
            tree = base_boundary(tree)
        return tree_map(lambda l, z: one(l, z, weights), tree, noise)

    return fn


def crossings(base_boundary, noised, noise, weights=None):
    """The ``boundary(tree)`` hook of one step for ``full_loss``: crossing
    ``i`` adds ``noise[i]`` through ``noised`` (``cut_noise_boundary``), so
    front->middle and middle->tail each take their own draws.  Without
    noise it is ``base_boundary``."""
    if noise is None:
        return base_boundary
    it = iter(noise)
    return lambda tree: noised(tree, next(it), weights)


def boundary_with_key(base_boundary, cfg: PrivacyConfig | None, gen,
                      codec=None):
    """Bind a generator into a ``boundary(tree)`` hook for ``full_loss``:
    each crossing draws fresh noise from ``gen`` (so two crossings' draws
    are independent).  Without cut noise it is ``base_boundary``."""
    if cfg is None or cfg.cut_noise_std <= 0:
        return base_boundary
    noised = cut_noise_boundary(base_boundary, codec)

    def fn(tree):
        return noised(tree, draw_noise(tree, gen, cfg.cut_noise_std))

    return fn
