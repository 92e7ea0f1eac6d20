"""repro_torch.wire — the cut-layer transport (codecs + training hook)."""

from repro_torch.wire.codec import (BF16Codec, Codec, IdentityCodec,
                                    Int8Codec, TopKCodec, make_codec,
                                    tree_wire_bytes)
from repro_torch.wire.transport import EpochSchedule, Transport

__all__ = ["Codec", "IdentityCodec", "BF16Codec", "Int8Codec", "TopKCodec",
           "make_codec", "tree_wire_bytes", "EpochSchedule", "Transport"]
