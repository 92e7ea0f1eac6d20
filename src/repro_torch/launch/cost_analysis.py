"""Per-device cost of one step on a mesh — the role of
``repro/launch/hlo_analysis.py`` (its code counts the ops of XLA's
partitioned HLO; PyTorch has no HLO).

A dry run (``launch.dryrun``) runs a step on DTensors of ``meta`` tensors
over a fake process group: nothing is allocated and nothing computed, but
DTensor lowers each global op into the per-device ops and collectives a
real run would issue.  Two dispatch modes read them:

  * ``CostMode`` sees the PER-DEVICE ops (it declines DTensor-level calls,
    so DTensor desugars them first) and counts
      - ``flops``: ``torch.utils.flop_counter``'s formulas (matmuls,
        convolutions, attention) on the local shapes;
      - ``hbm_bytes``: the operand and result bytes of every op that is
        not a view — unfused ATen ops, so an upper estimate of the HBM
        traffic where the reference counts XLA's fused ops;
      - collectives by kind (``all-gather``, ``reduce-scatter``,
        ``all-reduce``, ``all-to-all``): result bytes and counts, an
        all-reduce counted 2x (reduce then broadcast, the reference's
        ``_COLL_FACTOR``);
      - ``peak_live_bytes``: the most bytes of op results alive at once
        (the activations a backward keeps, and temporaries);
      - ``allocated_results``: op results that hold memory (``_allocated``;
        a dry run's must be 0: nothing was allocated);
    the ops that propagate DTensor shardings (on fake tensors) are not
    counted.
  * ``ReshardMode`` stands where XLA's SPMD partitioner resolves a
    sharding an op cannot take (a head count that does not divide the
    model axis, an op without a DTensor rule): when DTensor refuses an
    op, its DTensor operands are replicated over the model axes first,
    then over every axis, and at last the op runs on the full tensors,
    its result replicated; a lookup into a vocabulary-sharded operand
    (``GATHERS``) runs vocabulary-parallel.  Each such op is recorded
    (``resharded``), and the gathers it takes count as collectives.  A
    cache write into a sequence-sharded KV cache (``index_copy_`` along
    the sharded dim, ``WRITES``) runs on each device's block, as the
    partitioner writes a dynamic-update-slice in place.
"""

from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")
COLL_FACTOR = {"all-gather": 1.0, "reduce-scatter": 1.0, "all-reduce": 2.0,
               "all-to-all": 1.0}
_COLL_OPS = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
             "all_reduce": "all-reduce", "all_to_all": "all-to-all"}
# lookups into a vocabulary-sharded operand: DTensor's masked partial
# results of these do not survive a later reshape, so they run as
# vocabulary-parallel lookups with plain partial sums (``_sharded_lookup``)
GATHERS = ("gather", "index")
# writes into an operand sharded along the written dim: DTensor takes them
# as it takes other ops and re-places the operand it writes in place, so
# they run on each device's block (``_sharded_write``)
WRITES = ("index_copy_",)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _is_dtensor_type(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _fake(ts) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in ts)


def _allocated(ins, outs) -> int:
    """The results of one op that hold memory: any on an accelerator, and
    on the CPU those of an op that read a ``meta`` tensor (a step's data
    leaving ``meta``); DTensor's own shard bookkeeping makes small CPU
    tensors from nothing and is not counted."""
    from_meta = any(t.device.type == "meta" for t in ins)
    return sum(t.device.type not in ("meta", "cpu")
               or (from_meta and t.device.type == "cpu") for t in outs)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Count one step's per-device FLOPs, bytes and collectives (see the
    module docstring); read them from ``record()``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.coll_bytes = dict.fromkeys(COLLECTIVES, 0)
        self.coll_counts = dict.fromkeys(COLLECTIVES, 0)
        self.ops = collections.Counter()
        self.live = 0
        self.peak_live = 0
        self.allocated = 0          # results that hold memory

    def _release(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_type(types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if _fake(ins) or _fake(outs):
            return out              # DTensor's sharding propagation
        self.allocated += _allocated(ins, outs)
        name = func._overloadpacket.__name__
        kind = next((k for op, k in _COLL_OPS.items() if op in name), None)
        if kind is not None:
            self.coll_counts[kind] += 1
            self.coll_bytes[kind] += COLL_FACTOR[kind] * sum(
                _nbytes(t) for t in outs)
            return out
        if func.is_view or name in ("detach", "empty", "empty_strided",
                                    "empty_like", "wait_tensor",
                                    "_wrap_tensor_autograd"):
            return out
        from torch.utils.flop_counter import flop_registry
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
        self.ops[name] += 1
        aliased = {id(t) for t in ins}
        for t in outs:
            if id(t) in aliased:
                continue
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._release, n)
        self.peak_live = max(self.peak_live, self.live)
        return out

    def record(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collectives": {**{k: int(v) for k, v in
                                   self.coll_bytes.items()},
                                "counts": dict(self.coll_counts)},
                "peak_live_bytes": self.peak_live,
                "op_count": sum(self.ops.values()),
                "allocated_results": self.allocated}


class ReshardMode(TorchDispatchMode):
    """Resolve the shardings DTensor refuses (see the module docstring);
    ``model_axes`` are the mesh dims replicated first."""

    def __init__(self, model_axes=("model",)):
        super().__init__()
        self.model_axes = model_axes
        self.resharded = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _is_dtensor_type(types):
            return func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if name in GATHERS:
            out = _sharded_lookup(func, name, args)
            if out is not None:
                self.resharded[f"{name} (sharded lookup)"] += 1
                return out
        if name in WRITES and _sharded_write(func, args):
            self.resharded[f"{name} (sharded write)"] += 1
            return args[0]
        try:
            return func(*args, **kwargs)
        except Exception:  # noqa: BLE001 - a refusal, resolved below
            pass
        for full in (False, True):
            try:
                out = func(*self._replicate(args, full),
                           **self._replicate(kwargs, full))
            except Exception:  # noqa: BLE001 - a refusal, resolved below
                continue
            self.resharded[f"{name} (replicated "
                           f"{'all' if full else 'model'})"] += 1
            return out
        self.resharded[f"{name} (on full tensors)"] += 1
        return self._on_full(func, args, kwargs)

    def _replicate(self, tree, full: bool):
        from torch.distributed.tensor import DTensor, Replicate

        def one(x):
            if not isinstance(x, DTensor):
                return x
            names = x.device_mesh.mesh_dim_names or ()
            place = [Replicate() if full or (i < len(names)
                                              and names[i] in
                                              self.model_axes) else p
                     for i, p in enumerate(x.placements)]
            return x.redistribute(x.device_mesh, place)
        return _map(one, tree)

    def _on_full(self, func, args, kwargs):
        from torch.distributed.tensor import DTensor, Replicate
        meshes = [x.device_mesh for x in _tensors((args, kwargs))
                  if isinstance(x, DTensor)]
        mesh = meshes[0]
        local = _map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                     else x, (args, kwargs))
        out = func(*local[0], **local[1])
        return _map(lambda t: DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False)
            if isinstance(t, torch.Tensor) else t, out)


def _sharded_lookup(func, name, args):
    """A lookup into an operand sharded along the looked-up dim (an
    embedding table or logits over a "model"-sharded vocabulary) as the
    vocabulary-parallel op: each device looks up the ids that fall in its
    block (the others masked to zero) and the result is a partial sum over
    those mesh dims; None where the op is not such a lookup."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if name == "gather":
        src, dim, idx = args[0], args[1], args[2]
    elif name == "index" and len(args[1]) == 1 and args[1][0] is not None:
        src, dim, idx = args[0], 0, args[1][0]
    else:
        return None
    if not isinstance(src, DTensor):
        return None
    dim = dim % src.dim()
    mesh = src.device_mesh
    if any(isinstance(p, Partial) for p in src.placements):
        # a partial sum (logits of a contraction split over "model") is
        # reduce-scattered along the looked-up dim first
        src = src.redistribute(mesh, [Shard(dim) if isinstance(p, Partial)
                                      else p for p in src.placements])
    vocab = [i for i, p in enumerate(src.placements)
             if isinstance(p, Shard) and p.dim == dim]
    if not vocab or len(vocab) > 1:
        return None
    v = vocab[0]
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    # the ids: replicated over the vocabulary's mesh dim, as the operand
    # elsewhere (gather) or batch-placed (index)
    place = list(idx.placements)
    place[v] = Replicate()
    if name == "gather":
        place = [Replicate() if i == v else p
                 for i, p in enumerate(src.placements)]
    idx = idx.redistribute(mesh, place)
    loc, ids = src.to_local(), idx.to_local()
    n = loc.shape[dim]
    off = mesh.get_local_rank(v) * n
    local = ids - off
    valid = (local >= 0) & (local < n)
    local = local.clamp(0, n - 1)
    if name == "gather":
        out = func(loc, dim, local) * valid
        out_place = list(place)
    else:
        out = func(loc, [local]) * valid.unsqueeze(-1).to(loc.dtype)
        out_place = [Shard(p.dim) if isinstance(p, Shard) else p
                     for p in place]
        # the table's other dims carry their shards into the last dims
        for i, p in enumerate(src.placements):
            if isinstance(p, Shard) and p.dim != dim:
                out_place[i] = Shard(ids.dim() + p.dim - 1)
    out_place[v] = Partial()
    return DTensor.from_local(out, mesh, out_place, run_check=False)


def _sharded_write(func, args) -> bool:
    """``index_copy_(self, dim, index, source)`` with ``self`` sharded along
    ``dim`` as the write of each device's block: the index replicated,
    the source placed as ``self`` but whole along ``dim``, and each device
    writes the slots that fall in its block (the others rewrite their
    current value: exact while the clamped slots are distinct, as a
    decode step's one slot is).  False where the op is not such a
    write."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dst, dim, idx, src = args[:4]
    if not isinstance(dst, DTensor):
        return False
    dim = dim % dst.dim()
    mesh = dst.device_mesh
    seq = [i for i, p in enumerate(dst.placements)
           if isinstance(p, Shard) and p.dim == dim]
    if not seq:
        return False

    def placed(t, place):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, place).to_local()
    ids = placed(idx, [Replicate()] * mesh.ndim)
    val = placed(src, [Replicate() if i in seq else p
                       for i, p in enumerate(dst.placements)])
    loc = dst.to_local()
    n = loc.shape[dim]
    off = 0
    for i in seq:       # the block's offset: mesh dims in order, major first
        off = off * mesh.size(i) + mesh.get_local_rank(i)
    local = ids - off * n
    valid = (local >= 0) & (local < n)
    local = local.clamp(0, n - 1)
    shape = [1] * loc.dim()
    shape[dim] = -1
    keep = loc.index_select(dim, local)
    func(loc, dim, local, torch.where(valid.view(shape), val, keep))
    return True


def _map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


__all__ = ["CostMode", "ReshardMode", "COLLECTIVES", "COLL_FACTOR"]
