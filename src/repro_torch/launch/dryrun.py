"""The multi-device dry run: every (architecture x input shape x mesh)
step built against abstract shapes, nothing allocated — the role of
``repro/launch/dryrun.py`` (which lowers and compiles each step with XLA
for 256 or 512 virtual TPU chips), not its code.

PyTorch has no ahead-of-time SPMD compiler, so the port runs the step
itself on DTensors of ``meta`` tensors over a fake process group of the
mesh's size (``torch.distributed``'s ``fake`` backend, one process, rank
0): DTensor lowers every op to the per-device ops and collectives a real
run of that rank issues, and ``launch.cost_analysis`` counts them (FLOPs,
HBM bytes, collective bytes by kind) per device.  The record holds the
reference's fields where they have a counterpart: ``status``, the
per-device ``param_bytes``, ``opt_bytes``, ``input_bytes`` and
``peak_live_bytes`` (the activations and temporaries, where the reference
reads XLA's ``temp_size_in_bytes``), ``hlo_flops``, ``hlo_bytes``,
``collectives`` and, with ``--hw``, the three ``roofline`` terms.

  train_4k              -> SplitFedv3 (the paper's technique): each data
                           group is a virtual hospital with its own front
                           (``init_sflv3_params`` over as many hospitals
                           as the data axes hold, stacked on "clients");
                           the middle is shared, FSDP over the data axes
                           and tensor-parallel over "model";
                           ``--variant '{"compress": true}'`` puts the
                           int8 link (K1, K2) at the cut
  prefill_32k           -> the prefill forward (caches on the mesh)
  decode_32k/long_500k  -> one decode step against a seq_len cache

How the step runs per device.  The reference vmaps the hospitals' fronts
and lets XLA shard the vmapped axis; here each device runs ITS data
group's front on that group's rows (the stacked fronts' local block), and
the groups' cut activations are stitched into the middle's batch, sharded
over the data axes.  Parameters sharded over the data axes (FSDP) are
gathered before use, their gradients reduce-scattered.  Where DTensor
cannot take an op's sharding, ``cost_analysis.ReshardMode`` replicates
its operands as XLA's partitioner would, and the record lists those ops
(``resharded``).  The kernel wrappers take their plain versions on
``meta`` (``kernels.build.shapes_only``): nothing launches.

Usage (on the host; the card is never touched):
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
      [--shape S] [--mesh single|multi|both] [--out DIR] [--hw h100_sxm]
      [--variant JSON] [--tag T]
The records go to ``DIR/dryrun_<arch>_<shape>_<mesh>[_<tag>].json``
(default ``dryrun_results/``, git-ignored).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import optim as O
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import REGISTRY
from repro_torch.launch import mesh as MESH
from repro_torch.launch import specs as SPECS
from repro_torch.launch.train import get_axes_tree, param_shapes
from repro_torch.models.transformer import TransformerLM, token_nll
from repro_torch.optim import apply_updates
from repro_torch.tree import tree_leaves, tree_map

# Per-device peaks the roofline terms divide by, keyed by hardware: the
# reference's rows (a TPU v5e chip; a nominal CPU host) and the H100 the
# port runs on: 989e12 dense bf16 FLOP/s and 3.35e12 B/s of HBM3 (NVIDIA
# H100 SXM data sheet, at the 700 W limit), 450e9 B/s a direction of
# fourth-generation NVLink (900 GB/s both ways a GPU, the same sheet).
# ``ici_bw`` is the device's interconnect, whatever its kind.
HW_TABLE = {
    "tpu_v5e": {"peak_flops": 197e12, "hbm_bw": 819e9, "ici_bw": 50e9},
    "cpu_host": {"peak_flops": 2e12, "hbm_bw": 200e9, "ici_bw": 12.5e9},
    "h100_sxm": {"peak_flops": 989e12, "hbm_bw": 3.35e12, "ici_bw": 450e9},
}
DEFAULT_OUT = "dryrun_results"


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks (this process rank 0),
    destroyed on leaving whatever happens."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` on the current (fake) group: the
    production meshes, or any smaller one of the same axis names."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _apply_variant(cfg, variant: dict):
    fields = {k: v for k, v in (variant or {}).items()
              if k in {f.name for f in dataclasses.fields(cfg)}}
    return dataclasses.replace(cfg, **fields) if fields else cfg


def distribute(shapes, shardings):
    """Meta tensors -> DTensors placed by their ``Sharding``s."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map(lambda t, sh: distribute_tensor(
        t, sh.mesh, list(sh.placements())), shapes, shardings)


def _local_bytes(tree) -> int:
    """Bytes of one device's blocks of the tree's tensors."""
    return int(sum(getattr(t, "to_local", lambda t=t: t)().numel()
                   * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor)))


def _replace_dims(x, names, repl):
    """``x`` redistributed with the mesh dims named in ``names``
    replicated (an autograd-aware all-gather; its backward reduces)."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    place = [Replicate() if n in names else p
             for n, p in zip(mesh.mesh_dim_names, x.placements)]
    return x.redistribute(mesh, place) if place != list(x.placements) else x


def fsdp_gather(tree, mesh):
    """Every param with the data axes' shards gathered (FSDP's all-gather
    before use; tensor-parallel "model" shards stay)."""
    dp = MESH.dp_axes(mesh)
    return tree_map(lambda x: _replace_dims(x, dp, None), tree)


def group_local(x, mesh, lead: bool):
    """Each data group's own block as a DTensor replicated over the data
    axes: with ``lead`` the group's row of a stacked ``[C, ...]`` tree
    (its hospital's front), else its rows of a data-sharded batch."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dp = MESH.dp_axes(mesh)
    place = []
    for n, p in zip(mesh.mesh_dim_names, x.placements):
        if n in dp:
            place.append(Replicate())
        elif lead and isinstance(p, Shard):
            place.append(Shard(p.dim - 1))
        else:
            place.append(p)
    local = x.to_local()
    if lead:
        local = local[0]
    return DTensor.from_local(local, mesh, place, run_check=False)


def stitch_groups(h, mesh):
    """The data groups' blocks of rows (each replicated over the data
    axes) as one batch sharded over them, group-major: the cut crossing
    (a group's rows split over another axis, or partial sums, are gathered
    first: the link of the paper)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dp = MESH.dp_axes(mesh)
    whole = [Replicate() if n in dp or not isinstance(p, Shard)
             or p.dim == 0 else p
             for n, p in zip(mesh.mesh_dim_names, h.placements)]
    if whole != list(h.placements):
        h = h.redistribute(mesh, whole)
    place = [Shard(0) if n in dp else p
             for n, p in zip(mesh.mesh_dim_names, h.placements)]
    return DTensor.from_local(h.to_local(), mesh, place, run_check=False)


def sflv3_dry_step(model, opt, mesh, compress: bool = False):
    """The SplitFedv3 step as each device runs it (see the module
    docstring): ``step(params, opt_state, batch) -> (params, opt_state,
    loss)`` over DTensors, ``params`` ``init_sflv3_params``' tree."""
    boundary = None
    if compress:
        from repro_torch.kernels.act_compress.ops import compress_boundary
        boundary = compress_boundary

    def step(params, opt_state, batch):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        front = tree_map(lambda t: group_local(t, mesh, True), p["fronts"])
        toks = group_local(batch["tokens"], mesh, False)
        h, _, aux = model.apply({"front": front}, toks[:, :-1], train=True,
                                segment_range=(0, 1))
        h = stitch_groups(h, mesh)
        if boundary is not None:
            h = boundary(h)
        middle = fsdp_gather(p["middle"], mesh)
        logits, _, aux2 = model.apply({"front": front, "middle": middle}, h,
                                      train=True, segment_range=(1, 2))
        loss = token_nll(model.cfg, logits, batch["tokens"]).mean()
        loss = loss + aux + aux2
        leaves = tree_leaves(p)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter([torch.zeros_like(l) if g is None else g
                   for l, g in zip(leaves, grads)])
        grads = tree_map(lambda _: next(it), p)
        updates, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss.detach()
    return step


def build_train(entry, shape_name, mesh, variant=None):
    variant = variant or {}
    cfg = _apply_variant(entry.config, variant)
    model = TransformerLM.build(cfg)
    n_clients = SPECS.axes_size(mesh, MESH.dp_axes(mesh))
    shapes, axes = get_axes_tree(model, n_clients)
    params = distribute(shapes, MESH.tree_shardings(axes, shapes, mesh))
    opt = O.adam(1e-4, state_dtype=torch.bfloat16)
    opt_state = opt.init(params)
    batch, batch_sh = SPECS.train_batch_specs(cfg, shape_name, mesh)
    batch = distribute(batch, batch_sh)
    step = sflv3_dry_step(model, opt, mesh, variant.get("compress", False))
    return step, (params, opt_state, batch), dict(
        param_bytes=_local_bytes(params), opt_bytes=_local_bytes(opt_state),
        input_bytes=_local_bytes(batch))


def _full_params(cfg, mesh):
    model = TransformerLM.build(cfg)
    shapes = param_shapes(model)
    params = distribute(shapes, MESH.tree_shardings(model.init_axes(),
                                                    shapes, mesh))
    return model, params


def _cache(model, shape_name, mesh):
    shapes, shardings = SPECS.cache_specs(model, shape_name, mesh)
    return distribute(shapes, shardings)


def build_prefill(entry, shape_name, mesh, variant=None):
    cfg = _apply_variant(entry.config, variant or {})
    model, params = _full_params(cfg, mesh)
    batch, batch_sh = SPECS.prefill_batch_specs(cfg, shape_name, mesh)
    batch = distribute(batch, batch_sh)
    cache = _cache(model, shape_name, mesh)

    def step(params, batch):
        logits, cache_out, _ = model.apply(
            fsdp_gather(params, mesh), batch["tokens"],
            frontend_emb=batch.get("frontend_emb"), cache=cache)
        return logits[:, -1, :], cache_out
    return step, (params, batch), dict(
        param_bytes=_local_bytes(params), input_bytes=_local_bytes(batch),
        cache_bytes=_local_bytes(cache))


def build_decode(entry, shape_name, mesh, variant=None):
    cfg = _apply_variant(entry.config, variant or {})
    model, params = _full_params(cfg, mesh)
    cache = _cache(model, shape_name, mesh)
    toks, toks_sh = SPECS.decode_token_specs(shape_name, mesh)
    tokens, positions = (distribute(t, s) for t, s in zip(toks, toks_sh))

    def step(params, cache, tokens, positions):
        logits, cache_out, _ = model.apply(
            fsdp_gather(params, mesh), tokens, positions=positions,
            cache=cache)
        return logits[:, -1, :], cache_out
    return step, (params, cache, tokens, positions), dict(
        param_bytes=_local_bytes(params), cache_bytes=_local_bytes(cache),
        input_bytes=_local_bytes([tokens, positions]))


BUILDERS = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode}


def run_combo(arch_id: str, shape_name: str, multi_pod: bool = False,
              variant: dict | None = None, mesh_shape=None) -> dict:
    """One dry run; ``mesh_shape`` (a smaller mesh of the same axes, for
    tests) replaces the production one.  The fake process group lives for
    this call only."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels.build import shapes_only
    from repro_torch.launch.cost_analysis import CostMode, ReshardMode

    entry = REGISTRY[arch_id]
    mesh_name = "multi" if multi_pod else "single"
    shape, names = MESH.MULTI_POD if multi_pod else MESH.SINGLE_POD
    shape = tuple(mesh_shape or shape)
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "mesh_shape": list(shape), "status": "skipped", "notes": "",
           "variant": variant or {}}
    if shape_name not in entry.shapes:
        rec["notes"] = entry.skip_notes
        return rec
    kind = INPUT_SHAPES[shape_name]["kind"]
    t0 = time.time()
    n_dev = 1
    for s in shape:
        n_dev *= s
    try:
        with fake_group(n_dev):
            mesh = make_mesh(shape, names)
            step, args, sizes = BUILDERS[kind](entry, shape_name, mesh,
                                               variant)
            rec.update(sizes)
            rec["build_s"] = round(time.time() - t0, 1)
            t1 = time.time()
            cost, reshard = CostMode(), ReshardMode()
            grad = torch.enable_grad() if kind == "train" else \
                torch.no_grad()
            with shapes_only(), implicit_replication(), grad, \
                    torch.autograd.set_multithreading_enabled(False), \
                    cost, reshard:
                out = step(*args)
            del out
            rec["run_s"] = round(time.time() - t1, 1)
            c = cost.record()
            rec["hlo_flops"] = float(c["flops"])
            rec["hlo_bytes"] = float(c["hbm_bytes"])
            rec["collectives"] = c["collectives"]
            rec["peak_live_bytes"] = c["peak_live_bytes"]
            rec["op_count"] = c["op_count"]
            rec["allocated_results"] = c["allocated_results"]
            rec["resharded"] = dict(reshard.resharded)
            rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 - a failure is the record's
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def roofline_terms(rec: dict, mesh_chips: int, hw="h100_sxm") -> dict:
    """The three roofline terms in seconds, per device: FLOPs over the
    peak, HBM bytes over the HBM rate, collective bytes over the link
    rate; ``hw`` an ``HW_TABLE`` key or a peaks dict.  ``mesh_chips`` is
    kept for the reference's signature (the counts are per device)."""
    if isinstance(hw, str):
        hw = HW_TABLE[hw]
    coll = rec.get("collectives", {})
    coll_b = sum(v for k, v in coll.items() if k != "counts")
    t_compute = rec.get("hlo_flops", 0.0) / hw["peak_flops"]
    t_memory = rec.get("hlo_bytes", 0.0) / hw["hbm_bw"]
    t_coll = coll_b / hw["ici_bw"]
    dom = max((("compute", t_compute), ("memory", t_memory),
               ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {"t_compute": t_compute, "t_memory": t_memory,
            "t_collective": t_coll, "dominant": dom,
            "collective_bytes": coll_b}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--hw", default="h100_sxm", choices=list(HW_TABLE))
    ap.add_argument("--tag", default="", help="suffix for variant runs")
    ap.add_argument("--variant", default=None,
                    help='JSON config overrides, e.g. '
                         '\'{"vocab_pad_to": 256, "compress": true}\'')
    args = ap.parse_args(argv)
    variant = json.loads(args.variant) if args.variant else None
    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    archs = [args.arch] if args.arch else list(REGISTRY)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    for aid in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "multi" if mp else "single"
                tag = f"_{args.tag}" if args.tag else ""
                path = os.path.join(
                    args.out, f"dryrun_{aid}_{shape}_{mesh_name}{tag}.json")
                rec = run_combo(aid, shape, mp, variant=variant)
                if rec["status"] == "ok":
                    rec["roofline"] = roofline_terms(rec, 512 if mp else 256,
                                                     args.hw)
                    rec["hw"] = args.hw
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                msg = rec.get("error", "") or rec.get("notes", "")
                print(f"[{rec['status']:7s}] {aid:24s} {shape:12s} "
                      f"{mesh_name:6s} {rec.get('total_s', 0):7.1f}s  {msg}",
                      flush=True)


if __name__ == "__main__":
    main()
