"""LM train steps, the port of ``repro/launch/train.py``.

``make_sflv3_train_step`` is the paper's technique on the LM family: each
hospital keeps its own client (front) segment, stacked on a leading
hospital axis and never synchronized; the server (middle) segment is
shared, and its gradient is the mean over hospitals (SplitFedv3,
Algorithm 1).  The loss is the mean over hospitals of each hospital's
loss (its next-token cross-entropy plus its MoE balance losses), so each
front's gradient carries the factor 1/C, as in the reference.

Each hospital's rows run through its own front; the fronts' outputs are
concatenated along the batch axis, so the cut layer crosses the link in
ONE call (``compress=True``: the int8 codec, K1 then K2, launched once a
step) and the middle runs once on all hospitals' rows.  Two cases run the
middle hospital by hospital instead (one link call each): an MoE layer in
the middle whose dispatch chunks would straddle two hospitals' tokens
(each hospital's token count not a multiple of the chunk), which would
change the capacity drops, and a shared block held by the fronts, which
differs per hospital.  Both give what the reference's ``vmap`` over
hospitals gives.

``make_plain_train_step`` is the centralized baseline; ``param_shapes``
gives a model's param shapes without allocating, and ``get_axes_tree``
those shapes with their logical-axes tree (``launch/mesh.py`` maps it to
a mesh).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import token_nll
from repro_torch.optim import apply_updates
from repro_torch.tree import stack_trees, tree_leaves, tree_map


def init_sflv3_params(model, gen: torch.Generator, n_clients: int,
                      device=None):
    """``{"fronts": the C fronts stacked on a leading axis, "middle"}``:
    each hospital's front drawn from ``gen`` in turn, then the middle.
    The model must be label-sharing (no tail), as in the reference."""
    if len(model.segments) != 2:
        raise ValueError("SplitFedv3 LM training holds a front and a "
                         "middle: build the model with nls=False")
    device = resolve_device(device)
    fronts = [model.init_params(gen, device, segments=("front",))["front"]
              for _ in range(n_clients)]
    middle = model.init_params(gen, device, segments=("middle",))["middle"]
    return {"fronts": stack_trees(fronts), "middle": middle}


def _joint_middle(model, tokens_per_hospital: int) -> bool:
    """Whether the middle may run once on every hospital's rows and still
    compute what it computes on each hospital's alone."""
    front, middle = model.segments
    kinds = {r.kind for r in middle.runs}
    if front.has_shared and "shared" in kinds:
        return False
    if "moe" in kinds:
        chunk = model.cfg.moe_chunk
        return tokens_per_hospital >= chunk and tokens_per_hospital % chunk == 0
    return True


def _grads(loss, params):
    leaves = tree_leaves(params)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(l) if g is None else g
               for l, g in zip(leaves, gs)])
    return tree_map(lambda _: next(it), params)


def _fresh(params):
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


def make_sflv3_train_step(model, opt, n_clients: int,
                          compress: bool = False):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``.
    ``params`` is ``init_sflv3_params``' tree; ``batch["tokens"]`` holds
    the C hospitals' sequences one after another, (C * B, S + 1) on the
    params' device (``batch["frontend_emb"]``, if any, (C * B, F, dim)).
    ``compress`` puts ``act_compress.ops.compress_boundary`` at the cut:
    K1 then K2 forward, straight-through backward (the reference's TPU
    link)."""
    if compress:
        from repro_torch.kernels.act_compress.ops import compress_boundary
        boundary = compress_boundary
    else:
        boundary = None
    if len(model.segments) != 2:
        raise ValueError("SplitFedv3 LM training holds a front and a "
                         "middle: build the model with nls=False")

    def loss_fn(params, batch):
        toks = batch["tokens"]
        c = n_clients
        b = toks.shape[0] // c
        fe = batch.get("frontend_emb")
        fronts, hs = [], []
        total = torch.zeros((), device=toks.device)
        for i in range(c):
            front = tree_map(lambda x: x[i], params["fronts"])
            h, _, aux = model.apply(
                {"front": front}, toks[i * b:(i + 1) * b, :-1],
                frontend_emb=None if fe is None else fe[i * b:(i + 1) * b],
                train=True, segment_range=(0, 1))
            fronts.append(front)
            hs.append(h)
            total = total + aux
        groups = ([range(c)] if _joint_middle(model, b * hs[0].shape[1])
                  else [[i] for i in range(c)])
        for g in groups:
            h = torch.cat([hs[i] for i in g])
            if boundary is not None:
                h = boundary(h)
            rows = torch.cat([toks[i * b:(i + 1) * b] for i in g])
            # the front's shared block, where it owns one, reaches the
            # middle's shared applications (one hospital per group then)
            logits, _, aux = model.apply(
                {"front": fronts[g[0]], "middle": params["middle"]}, h,
                train=True, segment_range=(1, 2))
            nll = token_nll(model.cfg, logits, rows)
            total = total + nll.reshape(len(g), -1).mean(1).sum() \
                + aux * len(g)
        return total / c

    def train_step(params, opt_state, batch):
        p = _fresh(params)
        loss = loss_fn(p, batch)
        grads = _grads(loss, p)
        updates, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss.detach()

    return train_step


def make_plain_train_step(model, opt):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``:
    one update of the whole model on ``model.loss``."""
    def train_step(params, opt_state, batch):
        p = _fresh(params)
        loss = model.loss(p, batch, train=True)
        updates, opt_state = opt.update(_grads(loss, p), opt_state, params)
        return apply_updates(params, updates), opt_state, loss.detach()
    return train_step


def param_shapes(model):
    """The model's param tree on the ``meta`` device: every leaf's shape
    and dtype, nothing drawn or allocated (a full config of a trillion
    params included)."""
    return model.init_params(None, "meta")


def get_axes_tree(model, n_clients: int | None = None):
    """``(param shapes on meta, logical-axes tree)`` without allocating,
    the reference's ``get_axes_tree``: of ``init_params``' tree, or with
    ``n_clients`` of ``init_sflv3_params``' (the fronts stacked on a
    leading ``"clients"`` axis, the middle)."""
    shapes, axes = param_shapes(model), model.init_axes()
    if n_clients is None:
        return shapes, axes

    def lead(a):
        return (("clients",) + a if isinstance(a, tuple)
                else {k: lead(v) for k, v in a.items()})
    fronts = tree_map(lambda t: t.new_empty((n_clients, *t.shape)),
                      shapes["front"])
    return ({"fronts": fronts, "middle": shapes["middle"]},
            {"fronts": lead(axes["front"]), "middle": axes["middle"]})
