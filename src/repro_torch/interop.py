"""Parameter and state conversion between the reference's layouts (trees of
numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``) and the port's.

  * conv weights: HWIO in the reference, OIHW in the port (any 4-D leaf);
  * a dense weight is (in, out) in both;
  * SplitFedv3/v1's ``stacked_clients`` / ``c_opt`` carry a leading
    hospital axis in the reference and are per-hospital lists in the port;
    SL/SFLv2's stepwise state is per-hospital lists in both;
  * an LM's params keep the reference's tree as it is (segment ->
    ``run_<id>`` -> leaves with their leading layer axis), with no
    transposition: a stacked LM leaf is not a conv weight, so they do not
    go through ``params_from_jax``; an LM SplitFedv3 tree
    (``launch.train.init_sflv3_params``: ``fronts`` stacked on a leading
    hospital axis, ``middle``) and its Adam state keep that layout too
    (``lm_sflv3_from_jax``).

Only numpy crosses this module; it imports nothing of the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


def params_from_jax(tree, device="cpu"):
    """Tree of numpy arrays (reference layout) -> tree of tensors."""
    def one(a):
        a = np.asarray(a)
        if a.ndim == 4:                        # HWIO -> OIHW
            a = a.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.array(a, order="C")).to(device)
    return tree_map(one, tree)


def params_to_numpy(tree):
    """Tree of tensors -> tree of numpy arrays in the reference layout."""
    def one(t):
        a = t.detach().cpu().numpy()
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    return tree_map(one, tree)


def _unstack(tree, n):
    return [tree_map(lambda a: np.asarray(a)[i], tree) for i in range(n)]


def _adam_from_jax(opt, device, n=None, convert=None):
    """Reference Adam state ``{"step", "mu", "nu"}`` -> the port's (a list
    of ``n`` per-hospital states when the moments are stacked); the
    moments go through ``convert`` (``params_from_jax`` by default)."""
    convert = convert or params_from_jax
    step = torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int64,
                        device=device)
    if n is None:
        return {"step": step, "mu": convert(opt["mu"], device),
                "nu": convert(opt["nu"], device)}
    return [{"step": step.clone(), "mu": convert(m, device),
             "nu": convert(v, device)}
            for m, v in zip(_unstack(opt["mu"], n), _unstack(opt["nu"], n))]


def sflv3_state_from_jax(state, device="cpu"):
    """Reference SplitFedv3 state (``stacked_clients``, ``server``,
    ``c_opt``, ``s_opt``; numpy leaves) -> the port's state dict."""
    n = np.asarray(tree_leaves(state["stacked_clients"])[0]).shape[0]
    return {"clients": [params_from_jax(c, device)
                        for c in _unstack(state["stacked_clients"], n)],
            "server": params_from_jax(state["server"], device),
            "c_opts": _adam_from_jax(state["c_opt"], device, n),
            "s_opt": _adam_from_jax(state["s_opt"], device)}


def split_state_from_jax(state, device="cpu"):
    """Reference stepwise SL/SFLv2 state (``clients`` and ``c_opts`` lists,
    ``server``, ``s_opt``; numpy leaves; a client tree holds ``tail``
    under NLS) -> the port's state dict."""
    return {"clients": [params_from_jax(c, device)
                        for c in state["clients"]],
            "server": params_from_jax(state["server"], device),
            "c_opts": [_adam_from_jax(o, device) for o in state["c_opts"]],
            "s_opt": _adam_from_jax(state["s_opt"], device)}


def full_state_from_jax(state, device="cpu"):
    """Reference centralized (``params``, ``opt``) or FL (``params``)
    state -> the port's."""
    out = {"params": params_from_jax(state["params"], device)}
    if "opt" in state:
        out["opt"] = _adam_from_jax(state["opt"], device)
    return out


def lm_params_from_jax(tree, device="cpu"):
    """A reference LM param tree (numpy leaves) -> the port's, leaf for
    leaf."""
    return tree_map(lambda a: torch.from_numpy(
        np.array(np.asarray(a), order="C")).to(device), tree)


def lm_params_to_numpy(tree):
    """The port's LM params -> a tree of numpy arrays in the reference's
    layout (the inverse of ``lm_params_from_jax``)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def lm_sflv3_from_jax(params, opt=None, device="cpu"):
    """A reference LM SplitFedv3 param tree (``{"fronts": stacked on a
    leading hospital axis, "middle"}``; numpy leaves) and, if given, its
    Adam state ``{"step", "mu", "nu"}`` -> the port's, leaf for leaf with
    the stacked layout kept (so a global-norm clip and Adam see the
    reference's tree).  Returns the params, or ``(params, opt)``."""
    p = lm_params_from_jax(params, device)
    if opt is None:
        return p
    return p, _adam_from_jax(opt, device, convert=lm_params_from_jax)
