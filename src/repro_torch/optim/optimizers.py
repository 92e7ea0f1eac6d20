"""Functional optimizers over param dicts (no ``torch.optim``), the
counterpart of ``repro/optim/optimizers.py``:
``opt = adam(1e-4); state = opt.init(params);
updates, state = opt.update(grads, state);
params = apply_updates(params, updates)``.

Adam follows the reference op for op: moments in f32, bias corrections
``1 - b ** step`` computed in f32, ``eps`` added after the square root.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]   # (grads, state) -> (updates, state)


def _f32(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def adam(lr: float, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    """Adam with a constant step size (paper §3.2: b1=.9, b2=.999,
    lr=1e-4).  The reference's weight decay and schedules are ROADMAP M3."""
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"step": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state):
        step = state["step"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state["nu"], grads)
        like = tree_leaves(mu)[0]
        n = _f32(float(step), like)
        bc1 = 1 - torch.pow(_f32(b1, like), n)
        bc2 = 1 - torch.pow(_f32(b2, like), n)

        updates = tree_map(
            lambda m, v: -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps), mu, nu)
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


@torch.no_grad()
def tree_gaussian_noise(tree, gen: torch.Generator, std: float):
    """``tree + N(0, std^2)`` leaf-wise, each leaf's draw taken in turn from
    ``gen`` (on the leaves' device) in f32, each leaf's dtype kept — the
    counterpart of the reference's key-split-per-leaf version."""
    if std <= 0:
        return tree
    return tree_map(
        lambda l: l + (std * torch.randn(l.shape, generator=gen,
                                         device=l.device)).to(l.dtype),
        tree)
