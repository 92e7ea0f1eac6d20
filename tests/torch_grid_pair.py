"""Shared by the grid tests (``tests/test_torch_grid*.py``,
``tests/test_torch_engine_ref.py``): one row of the paper's Table-2 grid
run by the JAX reference and by the port on the CPU, both on the same
engine (stepwise unless asked), from the same weights (the reference's
``setup``, converted by ``repro_torch.interop``) and the same numpy batch
order (one ``default_rng`` seed on each side).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import numpy as np
import torch

from repro import optim as JO
from repro.configs.paper_models import DENSENET_MINI as J_DENSENET_MINI
from repro.configs.paper_models import UNET_MINI as J_UNET_MINI
from repro.core.partition import cnn_adapter as j_cnn_adapter
from repro.core.strategies import make_strategy as j_make_strategy
from repro.models.cnn import DenseNetConfig as JDenseNetConfig
from repro.models.cnn import build_densenet as j_build_densenet
from repro.models.cnn import build_unet as j_build_unet
from repro.wire import Transport as JTransport
from repro_torch import optim as TO
from repro_torch.configs.paper_models import DENSENET_MINI, UNET_MINI
from repro_torch.core.partition import cnn_adapter
from repro_torch.core.strategies import make_strategy
from repro_torch.interop import (full_state_from_jax, params_to_numpy,
                                 sflv3_state_from_jax, split_state_from_jax)
from repro_torch.models.cnn import DenseNetConfig, build_densenet, build_unet
from repro_torch.tree import tree_map
from repro_torch.wire import Transport

ROOT = Path(__file__).resolve().parents[1]
# the tiny DenseNet of tests/test_system.py
TINY = dict(growth=4, blocks=(1, 1), stem_ch=8, cut_layer=1)


def load(relpath: str):
    """A script of the repo (``benchmarks/``, ``tools/``) as a module."""
    spec = importlib.util.spec_from_file_location(Path(relpath).stem,
                                                  ROOT / relpath)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def adapters(arch: str, nls: bool):
    """(reference, port) adapters of one architecture and cut."""
    if arch == "tiny":
        return (j_cnn_adapter(j_build_densenet(JDenseNetConfig(**TINY),
                                               nls=nls)),
                cnn_adapter(build_densenet(DenseNetConfig(**TINY), nls=nls)))
    if arch == "densenet-mini":
        return (j_cnn_adapter(j_build_densenet(J_DENSENET_MINI, nls=nls)),
                cnn_adapter(build_densenet(DENSENET_MINI, nls=nls)))
    if arch == "unet-mini":
        return (j_cnn_adapter(j_build_unet(J_UNET_MINI, nls=nls)),
                cnn_adapter(build_unet(UNET_MINI, nls=nls)))
    raise KeyError(arch)


def port_state(method: str, start):
    """The reference's stepwise state (numpy leaves) -> the port's."""
    if method in ("centralized", "fl"):
        return full_state_from_jax(start, "cpu")
    if method.startswith(("sflv3", "sflv1")):
        return sflv3_state_from_jax(start, "cpu")
    return split_state_from_jax(start, "cpu")


def run_pair(method, nls, arch, clients, batch, lr, codec=None, epochs=1,
             privacy=(None, None), engine="stepwise", **kw):
    """``epochs`` epochs of one row in both packages over ``codec`` (None:
    no transport), one per hospital of ``clients``, on ``engine`` in both;
    ``privacy`` is the (reference, port) pair of ``PrivacyConfig``s.
    Returns a dict with the strategies, the state after each epoch
    (``states_j``/``states_t``), the logs and transports."""
    ja, ta = adapters(arch, nls)
    n = len(clients)
    tj = None if codec is None else JTransport(codec)
    tt = None if codec is None else Transport(codec, device="cpu")
    sj = j_make_strategy(method, ja, lambda: JO.adam(lr), n, transport=tj,
                         engine=engine, privacy=privacy[0], **kw)
    st = make_strategy(method, ta, lambda: TO.adam(lr), n, transport=tt,
                       engine=engine, device="cpu", privacy=privacy[1], **kw)
    state_j = sj.setup(jax.random.key(0))
    state_t = port_state(method, jax.tree.map(np.asarray, state_j))
    data = [c.train for c in clients]
    rng_j, rng_t = np.random.default_rng(1), np.random.default_rng(1)
    out = dict(sj=sj, st=st, tj=tj, tt=tt, ja=ja, ta=ta, states_j=[],
               states_t=[], logs_j=[], logs_t=[])
    for _ in range(epochs):
        state_j, log_j = sj.run_epoch(state_j, data, rng_j, batch)
        state_t, log_t = st.run_epoch(state_t, data, rng_t, batch)
        out["states_j"].append(jax.tree.map(np.asarray, state_j))
        # the port updates its state dict in place: keep this epoch's
        out["states_t"].append(tree_map(lambda x: x, state_t))
        out["logs_j"].append(log_j)
        out["logs_t"].append(log_t)
    return out


def client_trees(state):
    """Per-hospital client trees (numpy, reference layout) of either
    package's state: stacked (the reference's SFLv3/v1) or a list."""
    if "stacked_clients" in state:
        stacked = jax.tree.map(np.asarray, state["stacked_clients"])
        n = jax.tree.leaves(stacked)[0].shape[0]
        return [jax.tree.map(lambda a: a[i], stacked) for i in range(n)]
    return [c if isinstance(jax.tree.leaves(c)[0], np.ndarray)
            else params_to_numpy(c) for c in state["clients"]]


def param_pairs(method, state_j, state_t):
    """(reference, port) numpy trees of every param the row trains."""
    if method in ("centralized", "fl"):
        return [(state_j["params"], params_to_numpy(state_t["params"]))]
    pairs = list(zip(client_trees(state_j), client_trees(state_t)))
    pairs.append((state_j["server"], params_to_numpy(state_t["server"])))
    return pairs


def flat(tree, path=()):
    """{path: numpy leaf}, dict keys sorted (jax.tree's order)."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in flat(tree[k], path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in flat(t, path + (i,)).items()}
    return {path: np.asarray(tree.detach() if isinstance(tree, torch.Tensor)
                             else tree)}
