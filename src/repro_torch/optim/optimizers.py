"""Functional optimizers over param dicts (no ``torch.optim``), the
counterpart of ``repro/optim/optimizers.py``:
``opt = adam(1e-4); state = opt.init(params);
updates, state = opt.update(grads, state, params);
params = apply_updates(params, updates)``.

Adam follows the reference op for op: moments in f32 (stored in
``state_dtype``), bias corrections ``1 - b ** step`` computed in f32,
``eps`` added after the square root, AdamW's decay ``- lr_t * wd * p`` in
f32.  Every step count is an int64 tensor on the params' device, and a
callable ``lr`` (``optim.schedules``) is a tensor function of it, so an
update makes no host-to-device copy and no host decision: captured in a
CUDA graph, every replay reads and advances the count on the card and
takes that step's rate.

``add_noise`` keeps its PRNG state as a device count, as the reference
keeps its key in the optimizer state: update ``n`` draws a counter-based
stream (Threefry-2x32 of the seed and ``n``), so a captured graph draws
fresh noise at every replay, and a state that is copied, stacked or left
alone on a padding step draws exactly what the stepwise engine draws.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]   # (grads, state, params) -> (updates, state)


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def _count(params):
    return torch.zeros((), dtype=torch.int64, device=_device(params))


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    def init(params):
        mom = tree_map(torch.zeros_like, params) if momentum else None
        return {"step": _count(params), "mom": mom}

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g, state["mom"], grads)
            return (tree_map(lambda m: -lr_t * m, mom),
                    {"step": step, "mom": mom})
        return tree_map(lambda g: -lr_t * g, grads), {"step": step,
                                                      "mom": None}

    return Optimizer(init, update)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
         state_dtype=torch.float32) -> Optimizer:
    """Adam / AdamW (paper §3.2: Adam, b1=.9, b2=.999, lr=1e-4); ``lr`` a
    float or a schedule of the step count.  ``state_dtype=torch.bfloat16``
    stores the moments in bf16 (the arithmetic stays f32)."""
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=state_dtype)  # noqa: E731
        return {"step": _count(params), "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        mu = tree_map(lambda m, g: (b1 * m.float() + (1 - b1) * g.float())
                      .to(m.dtype), state["mu"], grads)
        nu = tree_map(lambda v, g: (b2 * v.float() + (1 - b2)
                                    * torch.square(g.float())).to(v.dtype),
                      state["nu"], grads)
        n = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full((), b1, device=n.device), n)
        bc2 = 1 - torch.pow(torch.full((), b2, device=n.device), n)

        def upd(m, v, p):
            m, v = m.float(), v.float()
            u = -lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and p is not None:
                u = u - lr_t * weight_decay * p.float()
            return u

        updates = (tree_map(upd, mu, nu, params) if params is not None
                   else tree_map(lambda m, v: upd(m, v, None), mu, nu))
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def init(params):
        return {}

    @torch.no_grad()
    def update(grads, state, params=None):
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in tree_leaves(grads)))
        # a true division (``float / tensor`` multiplies by a reciprocal)
        scale = torch.clamp(torch.full_like(norm, max_norm)
                            / torch.clamp_min(norm, 1e-9), max=1.0)
        return tree_map(lambda g: g * scale, grads), state

    return Optimizer(init, update)


_M32 = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al., SC 2011; the generator
    behind ``jax.random``): key words ``(k0, k1)`` and counter words
    ``(x0, x1)`` are int64 tensors or ints holding uint32 values, the two
    output words likewise.  Additions, rotations and xors only, so it runs
    on any device and inside a captured graph."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for r in range(20):
        x0 = (x0 + x1) & _M32
        rot = _ROTATIONS[r % 8]
        x1 = (((x1 << rot) | (x1 >> (32 - rot))) & _M32) ^ x0
        if r % 4 == 3:
            s = r // 4 + 1
            x0 = (x0 + ks[s % 3]) & _M32
            x1 = (x1 + ks[(s + 1) % 3] + s) & _M32
    return x0, x1


def _normal(shape, key, device) -> torch.Tensor:
    """N(0, 1) f32 draws of ``shape`` for ``key = (seed, count, leaf)``,
    ``count`` an int64 device tensor: element ``i`` is Box-Muller of the
    two Threefry words of counter ``(i, leaf)`` under key ``(seed,
    count)``, so the draws are a function of the key alone."""
    seed, count, leaf = key
    n = 1
    for d in shape:
        n *= int(d)
    if n > _M32:
        raise ValueError(f"a leaf of {n} elements exceeds the 2^32 counter")
    w0, w1 = threefry2x32(seed & _M32, count & _M32,
                          torch.arange(n, dtype=torch.int64, device=device),
                          leaf & _M32)
    u1 = ((w0 >> 8) + 1).to(torch.float32) * 2.0 ** -24      # (0, 1]
    u2 = (w1 >> 8).to(torch.float32) * 2.0 ** -24            # [0, 1)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2 * math.pi * u2)
    return z.reshape(shape)


@torch.no_grad()
def tree_gaussian_noise(tree, key, std: float):
    """``tree + N(0, std^2)`` leaf-wise, original leaf dtypes preserved;
    ``key = (seed, count)`` with ``count`` an int64 tensor on the tree's
    device, leaf ``j`` drawing ``_normal``'s stream ``(seed, count, j)``."""
    if std <= 0:
        return tree
    seed, count = key
    leaf = itertools.count()
    return tree_map(lambda l: l + (std * _normal(
        l.shape, (seed, count, next(leaf)), l.device)).to(l.dtype), tree)


def add_noise(std: float, seed: int = 0) -> Optimizer:
    """Additive iid Gaussian gradient noise (``chain`` it AFTER clipping
    for a DP-style update rule; ``repro_torch.privacy``'s per-example
    DP-SGD noises the clipped SUM instead).  The state is the update
    count, an int64 tensor on the params' device; update ``n`` draws
    ``tree_gaussian_noise``'s stream ``(seed, n)``, so a fresh state
    repeats the draws and every update (every replay of a captured step)
    draws new ones."""
    def init(params):
        return {"count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params=None):
        if std <= 0:
            return grads, state
        count = state["count"] + 1
        return (tree_gaussian_noise(grads, (seed, count), std),
                {"count": count})

    return Optimizer(init, update)


def chain(*opts: Optimizer) -> Optimizer:
    def init(params):
        return tuple(o.init(params) for o in opts)

    def update(grads, state, params=None):
        new_state = []
        for o, s in zip(opts, state):
            grads, s = o.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)
