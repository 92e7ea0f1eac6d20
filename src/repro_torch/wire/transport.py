"""Transport — the codec hook threaded through real training.

Counterpart of ``repro/wire/transport.py``.  ``Transport.boundary`` is the
differentiable roundtrip applied to the cut-layer activation between
segments: the server trains on exactly what it would have received.  With
the int8 codec and ``fuse=True`` (the default) that is one K3 launch per
crossing; ``fuse=False`` runs K1 then K2.  Lossy codecs backpropagate
straight through.

Byte accounting happens on the host from boundary SHAPES (``meta``
tensors): strategies call ``account`` once per training step and the
transport accumulates exact on-wire and raw byte counters, cached per
(adapter, batch shape).  Evaluation is neither accounted nor compressed —
clients score with their own full-precision segments, as in the paper.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.wire.codec import (Codec, make_codec, tree_roundtrip,
                                    tree_wire_bytes)


@dataclasses.dataclass(frozen=True)
class EpochSchedule:
    """One trained epoch's schedule signature (``Transport.record_epoch``):
    method kind, client interleaving, per-client train batch counts, the
    per-leg on-wire/raw byte sizes (``core.comm.leg_sizes``) and whether
    the split is U-shaped.  Under per-round participation ``client_set``
    holds the round's sampled global client ids (the others carry a zero
    ``tr_counts`` entry); None otherwise."""
    kind: str                   # "sl" | "sflv2" | "sflv3" | "sflv1"
    schedule: str               # "ac" | "am"
    tr_counts: tuple            # per-client train batch counts
    legs: dict                  # leg name -> bytes (act_fm, act_mt, ...)
    nls: bool
    client_set: tuple | None = None   # sampled global client ids


@dataclasses.dataclass
class Transport:
    codec: Codec
    #: run a fusable codec's roundtrip as ONE kernel (K3 for int8); set
    #: False for the quantize + dequantize pair (K1, K2).  Bit-equal.
    fuse: bool = True
    #: the device the boundary tensors lie on; None means the CUDA card,
    #: and a machine without one raises unless ``device="cpu"``.
    device: torch.device | str | None = None
    bytes_on_wire: float = 0.0
    bytes_raw: float = 0.0
    steps: int = 0
    epoch_log: list = dataclasses.field(default_factory=list, repr=False)
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.codec = make_codec(self.codec)
        self.device = resolve_device(self.device)

    # -- in-graph ------------------------------------------------------------
    def boundary(self, tree):
        """Encode+decode every leaf crossing a segment boundary."""
        def one(x):
            if x.device.type != self.device.type:
                raise ValueError(f"boundary tensor on {x.device}, transport "
                                 f"on {self.device}")
            if self.fused_codec is not None:
                return self.codec.fused_roundtrip(x)
            return self.codec.roundtrip(x)
        return tree_map(one, tree)

    @property
    def fused_codec(self):
        """The codec when its roundtrip runs as one fused kernel, else
        None."""
        return self.codec if self.fuse and self.codec.fusable else None

    # -- host-side accounting ------------------------------------------------
    @staticmethod
    def _shape_key(adapter, batch: dict):
        return (adapter,
                tuple(sorted((k, tuple(v.shape), str(v.dtype))
                             for k, v in batch.items())))

    def account(self, adapter, batch: dict, train: bool = True,
                count: int = 1):
        """Record ``count`` steps' boundary traffic: every crossing's
        activations, and in training their gradients back."""
        key = ("bytes", *self._shape_key(adapter, batch))
        if key not in self._cache:
            from repro_torch.core.partition import leaf_bytes
            specs = adapter.boundary_specs(batch)
            wire = sum(tree_wire_bytes(self.codec, t) for t in specs.values())
            raw = sum(leaf_bytes(t) for t in specs.values())
            self._cache[key] = (wire, raw)
        wire, raw = self._cache[key]
        legs = 2 if train else 1           # train: + gradient leg back
        self.bytes_on_wire += count * legs * wire
        self.bytes_raw += count * legs * raw
        self.steps += count

    def record_epoch(self, adapter, example_batch: dict, kind: str,
                     schedule: str, n_batches, client_set=None) -> None:
        """Append one trained epoch's schedule signature to ``epoch_log``;
        ``client_set`` marks a participating round's sampled clients."""
        key = ("legs", *self._shape_key(adapter, example_batch))
        if key not in self._cache:
            from repro_torch.core.comm import leg_sizes
            self._cache[key] = leg_sizes(adapter, example_batch,
                                         codec=self.codec)
        self.epoch_log.append(EpochSchedule(
            kind, schedule, tuple(int(n) for n in n_batches),
            self._cache[key], adapter.nls,
            None if client_set is None
            else tuple(int(c) for c in client_set)))

    @property
    def compression_ratio(self) -> float:
        if self.bytes_on_wire <= 0:
            return math.nan
        return self.bytes_raw / self.bytes_on_wire

    def reset(self):
        self.bytes_on_wire = self.bytes_raw = 0.0
        self.steps = 0
        self.epoch_log.clear()

    def summary(self) -> dict:
        return {"codec": self.codec.name, "steps": self.steps,
                "bytes_on_wire": self.bytes_on_wire,
                "bytes_raw": self.bytes_raw,
                "compression_ratio": self.compression_ratio}


@torch.no_grad()
def boundary_error(transport_or_codec, adapter, params, batch: dict) -> dict:
    """Reconstruction error of the codec on REAL boundary activations: for
    every crossing (``"front->"``, and ``"middle->"`` under NLS) a list of
    ``Codec.error`` dicts, one per leaf; the next segment reads the
    roundtripped tree, as in training.  ``batch`` holds tensors on the
    params' device; over ``Transport("int8")`` on the card each leaf runs
    K1 then K2 (``Int8Codec.roundtrip``) for its error and again for the
    next segment's input."""
    codec = (transport_or_codec.codec
             if isinstance(transport_or_codec, Transport)
             else make_codec(transport_or_codec))
    x = adapter.inputs(batch)
    errs = {}
    for seg in adapter.seg_names[:-1]:
        x = adapter.apply_seg(seg, params[seg], x, batch, False)
        errs[f"{seg}->"] = [codec.error(l) for l in tree_leaves(x)]
        x = tree_roundtrip(codec, x)
    return errs
