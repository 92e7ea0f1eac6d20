"""Device milliseconds a training step spends in convolution kernels
(cuDNN and GEMM classes, ``kernel_classes.json``), over the traced epochs
(their validation forwards included)."""

from perfbench.readings import class_us

LAYER = "CNN segments"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(rec):
    us = class_us(rec, ("conv",))
    if not us or not rec["steps"]:
        return None
    return us / 1e3 / rec["steps"]
