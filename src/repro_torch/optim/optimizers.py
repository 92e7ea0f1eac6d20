"""Functional optimizers over param dicts (no ``torch.optim``), the
counterpart of ``repro/optim/optimizers.py``:
``opt = adam(1e-4); state = opt.init(params);
updates, state = opt.update(grads, state);
params = apply_updates(params, updates)``.

Adam follows the reference op for op: moments in f32, bias corrections
``1 - b ** step`` computed in f32, ``eps`` added after the square root.
Its step count is an int64 tensor on the params' device, so an update
makes no host-to-device copy and can be captured in a CUDA graph: every
replay reads and advances the count on the card.
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


def adam(lr: float, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    """Adam with a constant step size (paper §3.2: b1=.9, b2=.999,
    lr=1e-4).  The reference's weight decay and schedules are ROADMAP M3."""
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        device = tree_leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int64, device=device),
                "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state):
        step = state["step"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state["nu"], grads)
        n = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full((), b1, device=n.device), n)
        bc2 = 1 - torch.pow(torch.full((), b2, device=n.device), n)

        updates = tree_map(
            lambda m, v: -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps), mu, nu)
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)
