"""``group_norm_relu``: K9 with its gradient, for the CNN segments.

The backward is two autograd nodes, as ATen's pair's is, so that the
incoming gradient is freed before GroupNorm's is made: ``_ReLUGrad`` masks
it where y is not positive (ReLU's ``threshold_backward``), then
``_GroupNormReLU`` hands the masked gradient to ATen's
``aten.native_group_norm_backward`` with K9's own mean and rstd, in f32 as
the forward's statistics are.  They save what ATen's pair saves: x as the
caller passed it, y, mean, rstd and gamma (the pre-ReLU tensor is never
made).  The NCHW copy that the forward makes of a channels_last x is
freed when the forward returns; the backward makes its own for as long as
it runs, as ATen's does.
Under ``torch.func.vmap`` (DP-SGD's per-example gradients) the vmapped
dimension folds into N, since GroupNorm is per example, and K9 launches
once for the whole batch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.group_norm.group_norm import group_norm_relu_fwd


class _GroupNormReLU(torch.autograd.Function):
    """(y, mean, rstd) of ``group_norm_relu_fwd``."""

    @staticmethod
    def forward(x, gamma, beta, groups, eps):
        return group_norm_relu_fwd(x, gamma, beta, groups, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, gamma, _, groups, _ = inputs
        _, mean, rstd = output
        ctx.mark_non_differentiable(mean, rstd)
        # the statistics take no gradient: the backward gets None for them
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, mean, rstd, gamma)
        ctx.groups = groups

    @staticmethod
    def backward(ctx, g, _gmean, _grstd):
        """g: the gradient of y already masked by ``_ReLUGrad``."""
        x, mean, rstd, gamma = ctx.saved_tensors
        n, c, h, w = x.shape
        dx, dgamma, dbeta = torch.ops.aten.native_group_norm_backward(
            g.float().contiguous(), x.float().contiguous(), mean, rstd, gamma,
            n, c, h * w, ctx.groups, list(ctx.needs_input_grad[:3]))
        return (None if dx is None else dx.to(x.dtype)), dgamma, dbeta, \
            None, None

    @staticmethod
    def vmap(info, in_dims, x, gamma, beta, groups, eps):
        xd, gd, bd = in_dims[:3]
        if gd is not None or bd is not None:
            raise NotImplementedError("group_norm_relu: vmap over the "
                                      "affine parameters")
        if xd is None:
            return (_GroupNormReLU.apply(x, gamma, beta, groups, eps),
                    (None,) * 3)
        x = x.movedim(xd, 0)
        out = _GroupNormReLU.apply(x.flatten(0, 1), gamma, beta, groups, eps)
        return tuple(t.unflatten(0, x.shape[:2]) for t in out), (0,) * 3


class _ReLUGrad(torch.autograd.Function):
    """The identity on K9's y (a view), whose backward is ReLU's."""

    generate_vmap_rule = True

    @staticmethod
    def forward(y):
        return y.view_as(y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, gy):
        return torch.ops.aten.threshold_backward(gy, ctx.saved_tensors[0], 0)


def group_norm_relu(x, gamma, beta, groups: int, eps: float = 1e-5):
    """relu(GroupNorm(x)): x (N, C, H, W) f32 or bf16, gamma and beta (C,)
    f32; the result NCHW-contiguous in x's dtype."""
    return _ReLUGrad.apply(_GroupNormReLU.apply(x, gamma, beta, groups,
                                                eps)[0])
