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

``add_noise`` keeps a ``torch.Generator`` in its state.  A captured graph
would replay the same draws every time, so the compiled engine refuses an
optimizer that holds one (``Optimizer.capturable``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]   # (grads, state, params) -> (updates, state)
    #: False when the state holds host objects a CUDA graph cannot replay
    #: (``add_noise``'s generator): the compiled engine raises on it
    capturable: bool = True


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


def _normal(shape, generator, device) -> torch.Tensor:
    """N(0, 1) f32 draws of ``shape`` from ``generator`` (one call per
    leaf, in leaf order)."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


@torch.no_grad()
def tree_gaussian_noise(tree, generator: torch.Generator, std: float):
    """``tree + N(0, std^2)`` leaf-wise, each leaf's draws the next of
    ``generator``'s stream, original leaf dtypes preserved."""
    if std <= 0:
        return tree
    return tree_map(lambda l: l + (std * _normal(l.shape, generator,
                                                 l.device)).to(l.dtype),
                    tree)


def add_noise(std: float, seed: int = 0) -> Optimizer:
    """Additive iid Gaussian gradient noise (``chain`` it AFTER clipping
    for a DP-style update rule; ``repro_torch.privacy``'s per-example
    DP-SGD noises the clipped SUM instead).  The generator, on the params'
    device and seeded with ``seed``, lives in the state and advances every
    update."""
    def init(params):
        return {"generator": torch.Generator(device=_device(params))
                .manual_seed(seed)}

    def update(grads, state, params=None):
        if std <= 0:
            return grads, state
        return tree_gaussian_noise(grads, state["generator"], std), state

    return Optimizer(init, update, capturable=False)


def chain(*opts: Optimizer) -> Optimizer:
    def init(params):
        return tuple(o.init(params) for o in opts)

    def update(grads, state, params=None):
        new_state = []
        for o, s in zip(opts, state):
            grads, s = o.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return Optimizer(init, update, all(o.capturable for o in opts))


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)
