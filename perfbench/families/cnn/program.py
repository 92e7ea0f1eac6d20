"""The system under test for the CNN families (``families/densenet``,
``families/unet``): the PyTorch and CUDA port's strategies
(``repro_torch``), built the way a user builds them.

``strategy`` makes the strategy with ``make_strategy`` on the compiled
engine (one captured CUDA graph per program body, replayed) over the int8
cut link, around the family's model adapter; ``load`` puts the benchmark's
weights into the strategy's own state; ``params`` and ``moments`` read the
state back as flat ``{path: tensor}`` dicts, the reference's layout, for
the comparison.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.cnn import flatten


def strategy(adapter, cfg: dict, traffic: dict, device: torch.device,
             precision: str | None = None):
    """The strategy of a cell: ``traffic``'s method, hospitals, link and
    optimizer over ``adapter`` (the port's ``cnn_adapter`` of ``cfg``'s
    model), in ``cfg``'s precision (``precision`` overrides it: the
    control's program path)."""
    from repro_torch import optim
    from repro_torch.core.strategies import make_strategy
    from repro_torch.wire import Transport

    link = traffic["link"]
    opt = traffic["optimizer"]
    if opt["name"] != "adam":
        raise ValueError(f"unknown optimizer {opt['name']!r}")
    transport = Transport(link["codec"], fuse=link["fused"], device=device)
    return make_strategy(
        traffic["method"], adapter,
        lambda: optim.adam(opt["lr"], b1=opt["b1"], b2=opt["b2"],
                           eps=opt["eps"]),
        len(traffic["train_images"]), transport=transport,
        engine=traffic["engine"], precision=precision or cfg["precision"],
        device=device)


def _client_path(path):
    return ("front",) + path


def load(strat, fronts: list, middle: dict) -> dict:
    """A fresh state of ``strat`` (zero Adam moments) holding the
    benchmark's weights: hospital h's front ``fronts[h]`` and the server's
    ``middle`` (flat {path: tensor} dicts, copied)."""
    state = strat.setup(0)
    with torch.no_grad():
        for h, client in enumerate(state["clients"]):
            _fill(client, {_client_path(p): t for p, t in fronts[h].items()})
        _fill(state["server"], middle)
    return state


def _fill(tree: dict, values: dict) -> None:
    flat = flatten(tree)
    if set(flat) != set(values):
        raise ValueError("the program's parameters differ from the "
                         f"reference's: {sorted(set(flat) ^ set(values))[:4]}")
    for path, t in flat.items():
        v = values[path]
        if tuple(t.shape) != tuple(v.shape):
            raise ValueError(f"{path}: program {tuple(t.shape)}, reference "
                             f"{tuple(v.shape)}")
        t.copy_(v)


def params(state) -> tuple:
    """(fronts, middle) of a state as flat dicts, cloned."""
    fronts = [{p[1:]: t.detach().clone()
               for p, t in flatten(c).items() if p[0] == "front"}
              for c in state["clients"]]
    return fronts, {p: t.detach().clone()
                    for p, t in flatten(state["server"]).items()}


def moments(state) -> tuple:
    """Adam's first moments of a state, (fronts, middle) as flat dicts: the
    gradients as the optimizers took them, averaged over their steps."""
    fronts = [{p[1:]: t.detach().clone()
               for p, t in flatten(o["mu"]).items() if p[0] == "front"}
              for o in state["c_opts"]]
    return fronts, {p: t.detach().clone()
                    for p, t in flatten(state["s_opt"]["mu"]).items()}


def epoch(strat, state, train: list, rng, batch: int):
    """One ``run_epoch`` of every hospital; returns (state, per-step
    losses as a numpy array [steps, hospitals or 1])."""
    state, log = strat.run_epoch(state, train, rng, batch)
    return state, np.asarray(log.losses).reshape(log.steps, -1)


def val_loss(strat, state, clients) -> float:
    return float(strat.val_loss(state, clients))


def dispatches(strat) -> int:
    """The strategy's count of program replays (``Strategy._dispatches``)."""
    return strat._dispatches


def attach_tracer(strat):
    """A ``repro_torch.obs.trace.Tracer`` on the strategy: its host spans
    (``run``, ``pack``, ``dispatch``)."""
    from repro_torch.obs.trace import Tracer
    return strat.attach_tracer(Tracer())
