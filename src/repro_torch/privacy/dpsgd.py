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

With ``noise_multiplier=0`` and ``clip_norm=inf`` (``force_dp``) the DP
path reduces to exact per-example-mean gradients — numerically the
non-private step.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.dp_clip.ops import clip_accumulate
from repro_torch.optim import tree_gaussian_noise
from repro_torch.tree import tree_map

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
                       (FL only, not ported yet: ROADMAP M8).
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

def per_example_grads(loss_fn, params, batch, extra=None):
    """vmapped (loss, grad) over singleton sub-batches.

    ``loss_fn(params, batch, extra) -> scalar`` must be a per-batch MEAN, so
    a size-1 batch yields that example's own loss and gradient.  ``extra``
    is an optional tree of per-example inputs with a leading B axis (the
    cut noise), split along with the batch.  Returns ((B,) losses, grad tree
    with a leading B axis).
    """
    def one(b, e):
        g, v = torch.func.grad_and_value(loss_fn)(params, b, e)
        return v, g
    single = lambda t: t.unsqueeze(1)                       # noqa: E731
    extra = None if extra is None else tree_map(single, extra)
    return torch.func.vmap(one, in_dims=(0, None if extra is None else 0))(
        tree_map(single, batch), extra)


def dp_value_and_grad(loss_fn, cfg: PrivacyConfig):
    """DP analogue of ``value_and_grad``.

    ``loss_fn(params, batch, extra) -> scalar``.  Returns ``fn(params,
    batch, gen, extra=None) -> (mean loss, noisy clipped mean grad)``:
    ``(sum_b clip(g_b) + sigma*C*z) / B`` with ``z ~ N(0, I)`` drawn from
    ``gen`` — the standard Abadi et al. DP-SGD estimator.  The reference's
    ``weights=`` (pad-and-mask rows of the compiled engine) is not ported:
    the stepwise engine has no padding rows.  The clip is K5/K6
    (``kernels/dp_clip``); the reference's ``use_kernel`` switch is not
    ported, since a CUDA tensor always launches the kernels.
    """
    # PrivacyConfig rejects noise > 0 with clip inf (unbounded sensitivity)
    noise_std = float(cfg.noise_multiplier) * float(cfg.clip_norm) \
        if cfg.noise_multiplier > 0 else 0.0

    def fn(params, batch, gen, extra=None):
        losses, grads = per_example_grads(loss_fn, params, batch, extra)
        b = losses.shape[0]
        summed, _ = clip_accumulate(grads, float(cfg.clip_norm))
        summed = tree_gaussian_noise(summed, gen, noise_std)
        grad = tree_map(lambda s, p: (s / b).to(p.dtype), summed, params)
        return losses.mean(), grad

    return fn


# ---------------------------------------------------------------------------
# cut-layer noise
# ---------------------------------------------------------------------------

def _leaf_noise(l, gen: torch.Generator, std: float):
    """std-scaled f32 Gaussian draws of ``l``'s shape from ``gen`` (on its
    device) — the ONE noise draw the fused and unfused paths both
    consume."""
    return std * torch.randn(l.shape, generator=gen, device=gen.device)


def draw_cut_noise(tree, gen: torch.Generator, std: float):
    """Pre-scaled noise for every leaf of a boundary tree (real or meta
    tensors), drawn in leaf order from ``gen``."""
    return tree_map(lambda l: _leaf_noise(l, gen, std), tree)


def cut_noise_boundary(base_boundary, codec=None):
    """Wrap a transport boundary fn with additive Gaussian cut-layer noise.

    Returns ``fn(tree, noise)``, ``noise`` the tree of pre-scaled draws
    (``draw_cut_noise``); the noise rides AFTER the codec roundtrip — the
    client adds it to exactly what ships (the reference draws inside and
    takes the std here; the port's draws come pre-scaled because ``vmap``
    refuses random ops).  The reference's ``weights`` (pad-and-mask rows of
    the compiled engine) are not ported: the stepwise engine has no padding
    rows.

    With a fusable ``codec`` (``Int8Codec``) the roundtrip AND the add are
    ONE K4 launch per leaf, in the same f32 op order as the unfused
    composition (the noise rounded to the activation's dtype, then the
    add), so fused == unfused bitwise; ``base_boundary`` is then skipped.
    """
    fused_rt = getattr(codec, "fused_noise_roundtrip", None)

    def one(l, z):
        if fused_rt is not None:
            return fused_rt(l, z)
        return l + z.to(l.dtype)

    def fn(tree, noise):
        if fused_rt is None and base_boundary is not None:
            tree = base_boundary(tree)
        return tree_map(one, tree, noise)

    return fn


def boundary_with_key(base_boundary, cfg: PrivacyConfig | None, gen,
                      codec=None):
    """Bind a generator into a ``boundary(tree)`` hook for ``full_loss``:
    each crossing draws fresh noise from ``gen`` (so two crossings' draws
    are independent).  Without cut noise it is ``base_boundary``."""
    if cfg is None or cfg.cut_noise_std <= 0:
        return base_boundary
    noised = cut_noise_boundary(base_boundary, codec)

    def fn(tree):
        return noised(tree, draw_cut_noise(tree, gen, cfg.cut_noise_std))

    return fn
