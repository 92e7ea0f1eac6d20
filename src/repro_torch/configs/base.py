"""The input shapes assigned to the LM architectures (the reference's
``repro/configs/base.py``).  Every LM config module exposes ``CONFIG``, the
published configuration (its source in ``source``), and ``SMOKE``, a
reduced same-family variant for CPU runs.  The registry waits for the
other model kinds."""

INPUT_SHAPES = {
    "train_4k":    {"seq_len": 4096,   "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768,  "global_batch": 32,  "kind": "prefill"},
    "decode_32k":  {"seq_len": 32768,  "global_batch": 128, "kind": "decode"},
    "long_500k":   {"seq_len": 524288, "global_batch": 1,   "kind": "decode"},
}
