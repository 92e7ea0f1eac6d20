"""K3's share of its bandwidth roofline: the bytes the fused int8 cut-layer
roundtrip must move (every boundary element read once and written once,
from the reference's boundary shapes, per step) over the card's HBM rate,
divided by K3's summed device time, over the traced epochs."""

import re


LAYER = "cut-layer link"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"
# K3's vector and general paths (``cut_layer.cu``), not K4's noise_ kernels
KERNEL = re.compile(r"(?<!noise_)roundtrip(_vec)?_kernel")


def read(rec):
    us = sum(b - a for n, a, b in rec["kernels"] if KERNEL.search(n))
    if not us or not rec["k3_bytes_per_step"]:
        return None
    bound_s = rec["k3_bytes_per_step"] * rec["steps"] / rec["hbm_bytes_per_s"]
    return 100.0 * bound_s / (us / 1e6)
