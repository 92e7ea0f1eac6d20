"""The whole training step's share of the card's peak: 3 x the reference's
forward FLOPs per image (``FlopCounterMode`` on meta tensors; a backward
counted as twice the forward, no recompute) x the images trained in the
traced epochs, over their wall time and the published peak of the
configuration's precision (``peaks.json``)."""

LAYER = "device"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(rec):
    if not rec["images"] or not rec["wall_s"] or not rec["kernels"]:
        return None
    flops = 3 * rec["flops_per_image"] * rec["images"]
    return 100.0 * flops / rec["wall_s"] / rec["peak_flops_per_s"]
