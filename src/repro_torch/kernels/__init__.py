"""Hand-written Hopper kernels of the port and their build loader."""

import torch


def straight_through(fn):
    """``fn`` with an identity backward: the gradient passes to ``x``
    unchanged (the cut-layer codecs' straight-through estimator)."""
    class _StraightThrough(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return fn(x)

        @staticmethod
        def backward(ctx, g):
            return g

    return _StraightThrough.apply
