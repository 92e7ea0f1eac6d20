"""Input specs and shardings per (arch x input shape), the port of
``repro/launch/specs.py``.

Nothing here allocates: full configs exist only as tensors on the
``meta`` device.  ``decode_*`` shapes include the KV/SSM cache tree, with
the production sharding policy:

  * decode_32k : cache batch -> data(/pod), cache seq -> model
  * long_500k  : batch == 1 (unshardable) -> cache seq over ALL mesh axes
  * sliding-window archs allocate only window-sized ring caches

A sharding is ``launch.mesh.Sharding`` (a mesh and the reference's
``PartitionSpec`` as a tuple); ``as_pspec=True`` returns the spec tuples.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import mesh as MESH


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_specs(cfg, b: int, s: int, mesh):
    dp = MESH.dp_axes(mesh)
    batch = {"tokens": meta((b, s), torch.int32)}
    shardings = {"tokens": MESH.Sharding(mesh, MESH.pspec(dp, None))}
    if cfg.frontend is not None:
        batch["frontend_emb"] = meta((b, cfg.frontend_tokens,
                                      cfg.frontend_dim), torch.bfloat16)
        shardings["frontend_emb"] = MESH.Sharding(mesh, MESH.pspec(
            dp, None, None))
    return batch, shardings


def train_batch_specs(cfg, shape_name: str, mesh):
    sh = INPUT_SHAPES[shape_name]
    return _batch_specs(cfg, sh["global_batch"], sh["seq_len"] + 1, mesh)


def prefill_batch_specs(cfg, shape_name: str, mesh):
    sh = INPUT_SHAPES[shape_name]
    return _batch_specs(cfg, sh["global_batch"], sh["seq_len"], mesh)


def axes_size(mesh, axes) -> int:
    sizes = dict(zip(MESH.axis_names(mesh), MESH.mesh_shape(mesh)))
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= sizes[a]
    return n


def decode_token_specs(shape_name: str, mesh):
    b = INPUT_SHAPES[shape_name]["global_batch"]
    dp = MESH.dp_axes(mesh)
    bspec = dp if b % axes_size(mesh, dp) == 0 else None
    shd = MESH.Sharding(mesh, MESH.pspec(bspec, None))
    return ((meta((b, 1), torch.int32), meta((b, 1), torch.int32)),
            (shd, shd))


# run caches carry a leading stacked-layer dim; shared-block caches do not
# (they are told apart by rank: k/v 5 vs 4, pos 3 vs 2, ...)
_BASE_RANK = {"k": 4, "v": 4, "pos": 2, "conv": 3, "ssm": 4, "index": 0}


def cache_specs(model, shape_name: str, mesh, dtype=torch.bfloat16,
                as_pspec: bool = False):
    """The cache tree on ``meta`` and its shardings for a decode shape
    (the attention caches' 0-d ``index`` is replicated: spec ``()``)."""
    sh = INPUT_SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    if model.cfg.frontend is not None:
        s += model.cfg.frontend_tokens          # prefix slots in the cache
    dp = MESH.dp_axes(mesh)
    sizes = dict(zip(MESH.axis_names(mesh), MESH.mesh_shape(mesh)))
    batch_shardable = b % axes_size(mesh, dp) == 0
    bspec = dp if batch_shardable else None
    # sequence dim: model axis normally; everything when batch unshardable
    seq_axes = (("model",) if batch_shardable
                else tuple(MESH.axis_names(mesh)))
    shapes = model.cache_init(b, s, dtype=dtype, device="meta")

    def fits(dim, axes):
        return dim % axes_size(mesh, axes) == 0

    def leaf_spec(name, leaf):
        rank = leaf.dim()
        stacked = 1 if rank == _BASE_RANK.get(name, rank) + 1 else 0
        lead = (None,) * stacked
        if name in ("k", "v", "pos"):
            tdim = leaf.shape[stacked + 1]
            return MESH.pspec(*lead, bspec, seq_axes if fits(tdim, seq_axes)
                          else None)
        if name == "conv":
            cspec = ("model",) if leaf.shape[-1] % sizes["model"] == 0 \
                else None
            return MESH.pspec(*lead, bspec, None, cspec)
        if name == "ssm":
            hspec = ("model",) if leaf.shape[stacked + 1] % \
                sizes["model"] == 0 else None
            return MESH.pspec(*lead, bspec, hspec)
        return ()

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else leaf_spec(k, v)
                for k, v in tree.items()}

    specs = walk(shapes)
    if as_pspec:
        return shapes, specs

    def wrap(t):
        return ({k: wrap(v) for k, v in t.items()} if isinstance(t, dict)
                else MESH.Sharding(mesh, t))
    return shapes, wrap(specs)


__all__ = ["train_batch_specs", "prefill_batch_specs", "decode_token_specs",
           "cache_specs", "axes_size", "meta"]
