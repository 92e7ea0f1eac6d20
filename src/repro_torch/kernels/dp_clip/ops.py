"""``clip_accumulate``, the DP-SGD hot path over a per-example gradient
tree: (clipped sum tree, (B,) per-example norms) out.  The clip factor is
one scalar per example over the whole parameter vector, so K5 sums the
squares across ALL leaves first; the scales ``min(1, C / ||g||)`` are taken
in PyTorch (B values), and K6 sums the scaled rows of every leaf.
Counterpart of ``repro/kernels/dp_clip/ops.py`` (which pads each leaf to
TPU tiles; nothing here needs padding).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dp_clip.dp_clip import (leaf_table,
                                                 scale_accum_leaves,
                                                 sqnorms_leaves)
from repro_torch.kernels.dp_clip.ref import clip_scales
from repro_torch.tree import tree_leaves, tree_map


def clip_accumulate(per_example_grads, clip_norm: float):
    """Tree of (B, ...) per-example grads -> (clipped-sum tree of the leaves'
    own shapes without B, (B,) L2 norms).  ``clip_norm`` inf disables the
    clip but still sums over the batch."""
    leaves = tree_leaves(per_example_grads)
    b = leaves[0].shape[0]
    table = leaf_table([l.reshape(b, -1).float().contiguous()
                        for l in leaves])
    sq = sqnorms_leaves(table).reshape(b, 1)
    sums = iter(scale_accum_leaves(table, clip_scales(sq, clip_norm)))
    out = tree_map(lambda l: next(sums).reshape(l.shape[1:]),
                   per_example_grads)
    return out, torch.sqrt(sq.clamp_min(0.0)).reshape(-1)
