"""Config registry plumbing (the reference's ``repro/configs/base.py``).

Every LM architecture ships as ``src/repro_torch/configs/<id>.py``
exposing:
  CONFIG — the exact published configuration (its source in ``source``);
  SMOKE  — a reduced same-family variant (about 2 layers, d_model <= 512,
           <= 4 experts) for CPU runs;
  ENTRY  — its ``ArchEntry`` in ``configs/registry.py``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import ModelConfig

# the input shapes assigned to the LM architectures
INPUT_SHAPES = {
    "train_4k":    {"seq_len": 4096,   "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768,  "global_batch": 32,  "kind": "prefill"},
    "decode_32k":  {"seq_len": 32768,  "global_batch": 128, "kind": "decode"},
    "long_500k":   {"seq_len": 524288, "global_batch": 1,   "kind": "decode"},
}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    config: ModelConfig
    smoke: ModelConfig
    shapes: tuple[str, ...]          # which INPUT_SHAPES this arch runs
    skip_notes: str = ""             # why any shape is skipped


_FULL = ("train_4k", "prefill_32k", "decode_32k")
_ALL = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
