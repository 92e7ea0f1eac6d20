"""Production mesh + logical-axis -> partition rules, the port of
``repro/launch/mesh.py``.

``make_production_mesh`` is a FUNCTION (importing this module touches no
device state and no process group).  Single pod: (16, 16) over ("data",
"model"), 256 devices; multi-pod: (2, 16, 16) over ("pod", "data",
"model"), 512, the pod axis carrying pure data parallelism (and FSDP for
the very largest params, see ``RULES``).  It returns a
``torch.distributed.device_mesh.DeviceMesh``, so it needs a process group
of that world size (the dry run's fake one, ``launch.dryrun``).

The rules map the *logical* axis names of every ``*_axes`` tree of
``repro_torch.models`` to mesh axes, with two safety conditions per leaf:
  * a mesh axis is used at most once per spec,
  * a dim is sharded only if its size is divisible by the axis size
    (MiniCPM's deliberately odd 122753 vocab stays replicated).

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
leading tensor dim, a mesh-axis name, a tuple of names, or None
(``spec_for`` drops the trailing Nones).  ``placements`` turns it into
DTensor ``Shard``/``Replicate`` placements, one per mesh dim.  The rule
functions take any mesh with ``axis_names`` and a device array's
``shape`` (``devices.shape`` of a test's fake mesh, ``mesh.shape`` of a
``DeviceMesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

# logical axis -> candidate mesh axes, in preference order.  The first
# candidate that is free (not already used in this spec) and divides the
# dim size wins; otherwise the dim is replicated.
RULES: dict[str, tuple[str, ...]] = {
    "vocab": ("model",),
    "ff": ("model",),
    "heads_flat": ("model",),
    "experts": ("model",),
    "inner_proj": ("model",),
    "inner": ("model",),
    "embed": ("data", "pod"),        # FSDP over data (and pod when free)
    "frontend": (),
    "kv_flat": (),                   # kv heads < model axis: replicate
    "experts_r": (),
    "heads": (),
    "layers": (),                    # stacked layer dim
    "chan": (), "chan_in": (), "classes": (),
    # stacked per-client (hospital) axes: the 1-D ("hosp",) layout of
    # core.placement when present, else data parallelism on the
    # production meshes (SFLv3 stacked fronts, engine batch stacks)
    "clients": ("hosp", "data"),
}

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def mesh_shape(mesh) -> tuple:
    """The device-array shape of ``mesh`` (a ``DeviceMesh`` or any object
    with ``devices.shape``)."""
    devices = getattr(mesh, "devices", None)
    if devices is not None and hasattr(devices, "shape"):
        return tuple(devices.shape)
    return tuple(mesh.shape)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The production ``DeviceMesh`` over the default process group (world
    size 256, or 512 with ``multi_pod``)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes carrying batch/data parallelism."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def spec_for(axes: tuple, shape: tuple, mesh) -> tuple:
    used: set[str] = set()
    out = []
    sizes = dict(zip(axis_names(mesh), mesh_shape(mesh)))
    for ax_name, dim in zip(axes, shape):
        choice = None
        if ax_name is not None:
            for cand in RULES.get(ax_name, ()):
                if cand in sizes and cand not in used and \
                        dim % sizes[cand] == 0:
                    choice = cand
                    used.add(cand)
                    break
        out.append(choice)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def pspec(*entries) -> tuple:
    """A spec of these entries as the reference's ``PartitionSpec`` holds
    them: a one-axis tuple becomes the bare axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)`` where
    the mesh axis shards tensor dim ``d``, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(mesh):
        dim = next((i for i, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a leaf lives: a mesh and a spec (the reference's
    ``NamedSharding``)."""
    mesh: Any
    spec: tuple

    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape: tuple) -> tuple:
        """The shape of one device's block of a ``shape`` leaf."""
        sizes = dict(zip(axis_names(self.mesh), mesh_shape(self.mesh)))
        out = list(shape)
        for i, e in enumerate(self.spec):
            for name in (e if isinstance(e, tuple) else (e,)):
                if name is not None:
                    out[i] //= sizes[name]
        return tuple(out)


def is_axes_leaf(v) -> bool:
    return isinstance(v, tuple) and all(isinstance(x, (str, type(None)))
                                        for x in v)


def map_axes(fn, axes_tree, *rest):
    """``fn(axes, *leaves)`` over an axes tree (tuples of names are its
    leaves) and trees of the same structure."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, *rest)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(r[k] for r in rest))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(map_axes(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(axes_tree))
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def tree_shardings(axes_tree: Any, shape_tree: Any, mesh):
    """A ``Sharding`` tree from the logical-axes tree of a model's init and
    a matching tree of shaped leaves (tensors on ``meta``, or anything with
    a ``shape``)."""
    return map_axes(lambda axes, leaf: Sharding(
        mesh, spec_for(axes, tuple(leaf.shape), mesh)), axes_tree,
        shape_tree)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh, rank: int, batch_dim: int = 0) -> Sharding:
    spec = [None] * rank
    spec[batch_dim] = dp_axes(mesh)
    return Sharding(mesh, pspec(*spec))


__all__ = ["RULES", "make_production_mesh", "dp_axes", "spec_for", "pspec",
           "placements", "Sharding", "tree_shardings", "replicated",
           "batch_sharding", "map_axes", "is_axes_leaf", "mesh_shape",
           "axis_names"]
