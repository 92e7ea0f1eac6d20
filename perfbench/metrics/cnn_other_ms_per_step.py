"""Device milliseconds a training step spends in the CNN segments' other
kernels: group norm, cat and copy, and every kernel of no class (ReLU,
pools, Adam, the loss), that is all but the hand kernels, convolutions and
memory copies, over the traced epochs."""

from perfbench.readings import class_us

LAYER = "CNN segments"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(rec):
    us = class_us(rec, ("group_norm", "cat_copy", "other"))
    if not us or not rec["steps"]:
        return None
    return us / 1e3 / rec["steps"]
