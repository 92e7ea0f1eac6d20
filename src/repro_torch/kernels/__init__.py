"""Hand-written Hopper kernels of the port and their build loader."""

import torch


def straight_through(fn, rowwise=True):
    """``fn(x, *extra)`` with an identity backward: the gradient passes to
    ``x`` unchanged (the cut-layer codecs' straight-through estimator) and
    the ``extra`` inputs (the cut noise) get none.

    It works under ``torch.func`` transforms, as DP-SGD's per-example
    ``vmap(grad)`` needs.  Under ``vmap`` every input is moved (or, when
    not vmapped, expanded) to a leading vmapped dimension.  A ``rowwise``
    ``fn`` (one that treats each row of the last axis on its own, as the
    int8 codec does) then runs once on the whole batch, so its kernel
    launches once for every example together; any other ``fn`` (top-k over
    the whole tensor) runs once per example.
    """
    class _StraightThrough(torch.autograd.Function):
        @staticmethod
        def forward(x, *extra):
            return fn(x, *extra)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.n_extra = len(inputs) - 1

        @staticmethod
        def backward(ctx, g):
            return (g,) + (None,) * ctx.n_extra

        @staticmethod
        def vmap(info, in_dims, *inputs):
            if all(d is None for d in in_dims):
                return fn(*inputs), None
            inputs = [t.expand(info.batch_size, *t.shape) if d is None
                      else t.movedim(d, 0) for t, d in zip(inputs, in_dims)]
            if rowwise:
                return fn(*inputs), 0
            return torch.stack([fn(*ts) for ts in
                                zip(*(t.unbind(0) for t in inputs))]), 0

    return _StraightThrough.apply
