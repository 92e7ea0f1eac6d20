"""Cut-layer codecs — what crosses the client<->server wire.

Counterpart of ``repro/wire/codec.py``.  A ``Codec`` turns one boundary
activation leaf into its on-wire payload and back, reports the EXACT bytes
that payload occupies, and gives the in-graph ``roundtrip`` the transport
applies during training; every lossy codec backpropagates straight through
(``torch.autograd.Function``).

  * ``identity`` — ships the tensor as-is (the paper's measured regime).
  * ``bf16``     — casts to bfloat16 on the wire (2 bytes/element).
  * ``int8``     — per-row absmax int8 + one f32 scale per row over the LAST
                   axis, on the K1/K2/K3 kernels (``repro_torch.kernels``),
                   and K4 when cut-layer noise rides the same pass.
  * ``topk``     — top ``frac`` of elements by magnitude ship as (value,
                   int32 index) pairs, the rest decode to zero.

``wire_bytes`` reads only ``.shape`` and ``.dtype``, so it takes real or
``meta`` tensors alike.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import straight_through
from repro_torch.tree import tree_leaves


def _nelem(spec) -> int:
    return math.prod(spec.shape)


class Codec:
    """One boundary leaf -> on-wire payload -> reconstruction."""

    name: str = "codec"
    #: True when ``kernels/cut_fuse`` implements the roundtrip as one fused
    #: kernel; ``Transport.boundary`` then launches it (``fuse=True``).
    fusable: bool = False

    def encode(self, x):
        raise NotImplementedError

    def decode(self, payload, like):
        raise NotImplementedError

    def wire_bytes(self, spec) -> int:
        raise NotImplementedError

    def roundtrip(self, x):
        raise NotImplementedError


class IdentityCodec(Codec):
    name = "identity"

    def encode(self, x):
        return {"x": x}

    def decode(self, payload, like):
        return payload["x"]

    def wire_bytes(self, spec) -> int:
        return _nelem(spec) * spec.dtype.itemsize

    def roundtrip(self, x):
        return x


class BF16Codec(Codec):
    name = "bf16"

    def __init__(self):
        self._rt = straight_through(lambda x: x.to(torch.bfloat16).to(x.dtype))

    def encode(self, x):
        return {"x": x.to(torch.bfloat16)}

    def decode(self, payload, like):
        return payload["x"].to(like.dtype)

    def wire_bytes(self, spec) -> int:
        return _nelem(spec) * 2

    def roundtrip(self, x):
        return x if x.dtype == torch.bfloat16 else self._rt(x)


class Int8Codec(Codec):
    """Per-row absmax int8 + f32 row scale (K1/K2, fused K3; ~4x vs f32)."""

    name = "int8"
    fusable = True

    def encode(self, x):
        from repro_torch.kernels.act_compress.ops import quantize
        q, s = quantize(x)
        return {"q": q, "scale": s}

    def decode(self, payload, like):
        from repro_torch.kernels.act_compress.ops import dequantize
        return dequantize(payload["q"], payload["scale"], like.dtype)

    def wire_bytes(self, spec) -> int:
        rows = _nelem(spec) // (spec.shape[-1] if len(spec.shape) else 1)
        return _nelem(spec) + 4 * max(rows, 1)

    def roundtrip(self, x):
        """K1 then K2 (two launches), straight-through."""
        from repro_torch.kernels.act_compress.ops import compress_boundary
        return compress_boundary(x)

    def fused_roundtrip(self, x):
        """K3 (one launch, the int8 never written), bit-equal to
        ``roundtrip``, straight-through."""
        from repro_torch.kernels.cut_fuse.ops import roundtrip_boundary
        return roundtrip_boundary(x)

    def fused_noise_roundtrip(self, x, z):
        """K4: ``roundtrip(x) + z.to(x.dtype)`` in one launch, bit-equal to
        ``roundtrip`` followed by the separate noise add; straight-through
        in ``x``."""
        from repro_torch.kernels.cut_fuse.ops import cut_noise_roundtrip
        return cut_noise_roundtrip(x, z)


class TopKCodec(Codec):
    """Magnitude top-k sparsification: ship (value, int32 index) pairs."""

    def __init__(self, frac: float = 0.1):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk fraction must be in (0, 1], got {frac}")
        self.frac = frac
        self.name = f"topk:{frac:g}"

        def rt(x):
            flat = x.reshape(-1)
            idx = torch.topk(flat.float().abs(), self._k(flat.numel())).indices
            out = torch.zeros_like(flat)
            out[idx] = flat[idx]
            return out.reshape(x.shape)

        self._rt = straight_through(rt, rowwise=False)

    def _k(self, n: int) -> int:
        return max(1, int(math.ceil(self.frac * n)))

    def encode(self, x):
        flat = x.reshape(-1)
        idx = torch.topk(flat.float().abs(), self._k(flat.numel())).indices
        return {"values": flat[idx], "indices": idx.to(torch.int32)}

    def decode(self, payload, like):
        flat = torch.zeros((_nelem(like),), dtype=like.dtype,
                           device=payload["values"].device)
        flat[payload["indices"].long()] = payload["values"].to(like.dtype)
        return flat.reshape(like.shape)

    def wire_bytes(self, spec) -> int:
        return self._k(_nelem(spec)) * (spec.dtype.itemsize + 4)

    def roundtrip(self, x):
        return self._rt(x)


def make_codec(name) -> Codec:
    """``identity | bf16 | int8 | topk[:frac]`` (or pass a Codec through)."""
    if isinstance(name, Codec):
        return name
    if name.startswith("topk"):
        _, _, frac = name.partition(":")
        return TopKCodec(float(frac) if frac else 0.1)
    try:
        return {"identity": IdentityCodec, "bf16": BF16Codec,
                "int8": Int8Codec}[name]()
    except KeyError:
        raise KeyError(f"unknown codec {name!r} "
                       "(identity | bf16 | int8 | topk[:frac])") from None


def tree_wire_bytes(codec: Codec, tree) -> int:
    """Total on-wire bytes of a boundary pytree (meta or real tensors)."""
    return int(sum(codec.wire_bytes(l) for l in tree_leaves(tree)))
