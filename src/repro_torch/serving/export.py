"""Checkpoint export — the train side of the train→deploy loop
(counterpart of ``repro/serving/export.py``).

``Strategy.export(state, client_idx)`` materializes the full deployable
model from any training strategy as a ``ServableModel``:

  * centralized / FL: the one global param tree (``client_idx`` is moot);
  * SL / SFLv2 / SFLv3 / SFLv1: hospital ``client_idx``'s client
    segment(s) stitched with the shared server segment at the cut — the
    composition ``Strategy.params_for_eval`` scores with.

``ServableModel.scores`` and ``Strategy.scores`` are one function
(``core.partition.grid_scores``) on one batching grid, so an export scores
bit for bit as its strategy.

``save_servable`` / ``load_servable`` round-trip the export through one
file in the reference's format (``train.checkpoint``: a msgpack map of the
JSON meta record and the flattened params, in the reference's order and
layout), so either package loads the other's exports; loading needs only
the adapter, whose ``init`` on the meta device gives the param structure.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.core.partition import META, SplitAdapter, grid_scores
from repro_torch.device import resolve_device
from repro_torch.train import checkpoint as CK


@dataclasses.dataclass
class ServableModel:
    """A deployable full model: adapter + stitched param tree (tensors on
    one device) + metadata.  ``shared`` mirrors the strategy's
    ``shared_eval_params`` (one tree for every hospital)."""
    adapter: SplitAdapter
    params: dict
    shared: bool
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def family(self) -> str:
        return self.adapter.name

    def scores(self, data: dict, batch_size: int = 60,
               chunk_batches: int | None = None) -> np.ndarray:
        """Per-sample scores for every sample of ``data`` (numpy arrays):
        ``Strategy.scores``' grid and function, so bit-equal to it."""
        return grid_scores(self.adapter, self.params, data, batch_size,
                           chunk_batches)


def save_servable(path: str, servable: ServableModel) -> None:
    """One file: the JSON-safe meta record and the flattened params, byte
    for byte the reference's ``save_servable`` file of the same converted
    params and meta."""
    CK.write(path, {
        "__meta__": json.dumps({**servable.meta,
                                "family": servable.family,
                                "shared": bool(servable.shared)}),
        "params": CK.records(servable.params)})


def load_servable(path: str, adapter: SplitAdapter,
                  device=None) -> ServableModel:
    """Restore an export (the port's or the reference's) onto ``device``
    (the CUDA card by default); the param structure comes from
    ``adapter.init`` (segments the adapter lacks are not read).  A leaf the
    file lacks, or of another shape, raises ``ValueError``."""
    device = resolve_device(device)
    payload = CK.read(path)
    meta = json.loads(payload["__meta__"])
    recs = payload["params"]
    like = adapter.init(None, META)
    flat = dict(CK.tree_paths(like))
    missing = [k for k in flat if k not in recs]
    if missing:
        raise ValueError(f"checkpoint {path} lacks params for {missing[:3]}"
                         f"{'...' if len(missing) > 3 else ''}")
    for key, spec in flat.items():
        want = CK.ref_shape(spec.shape)
        if tuple(recs[key]["shape"]) != want:
            raise ValueError(
                f"checkpoint {path} param {key!r} has shape "
                f"{tuple(recs[key]['shape'])}, adapter expects {want} — "
                "architecture mismatch")
    params = CK.map_paths(lambda k, _: CK.tensor_of(recs[k], device), like)
    shared = bool(meta.pop("shared"))
    meta.pop("family", None)
    return ServableModel(adapter=adapter, params=params, shared=shared,
                         meta=meta)


__all__ = ["ServableModel", "save_servable", "load_servable"]
