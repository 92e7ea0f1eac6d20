"""repro_torch.wire — the cut-layer transport subsystem (counterpart of
``repro.wire``).

  * ``codec``     — what ships: identity / bf16 / int8 (K1-K4) / top-k,
                    each with exact on-wire byte counts and straight-through
                    roundtrips.
  * ``network``   — what it costs: bandwidth/RTT/jitter/straggler models
                    with ``lan`` / ``hospital_wan`` / ``cellular`` presets.
  * ``simulator`` — event-driven replay of one epoch's transfer DAG:
                    per-method wall-clock, per-client timelines,
                    straggler sensitivity; ``timeline_from_accounting``
                    expands a trained Transport's per-epoch accounting
                    back into the same per-step timelines.
  * ``transport`` — the training-time hook: strategies roundtrip the
                    cut-layer tensors, meter real bytes and record
                    per-epoch schedule signatures for the simulator.
"""

from repro_torch.wire.codec import (BF16Codec, CODECS, Codec, IdentityCodec,
                                    Int8Codec, TopKCodec, make_codec,
                                    tree_roundtrip, tree_wire_bytes)
from repro_torch.wire.network import SCENARIOS, NetworkModel, make_network
from repro_torch.wire.simulator import (SimResult, Transfer, WireEvent,
                                        build_transfers, replay, simulate,
                                        straggler_sensitivity,
                                        timeline_from_accounting)
from repro_torch.wire.transport import (EpochSchedule, Transport,
                                        boundary_error)

__all__ = [
    "Codec", "IdentityCodec", "BF16Codec", "Int8Codec", "TopKCodec",
    "make_codec", "tree_roundtrip", "tree_wire_bytes", "CODECS",
    "NetworkModel", "SCENARIOS", "make_network",
    "Transfer", "WireEvent", "SimResult", "build_transfers", "replay",
    "simulate", "straggler_sensitivity", "timeline_from_accounting",
    "EpochSchedule", "Transport", "boundary_error",
]
