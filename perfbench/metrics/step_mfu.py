"""The whole training step's share of the card's peak: 3 x the family
reference's forward FLOPs per sample (``forward_flops``: the CNNs' by
``FlopCounterMode`` on meta tensors; a backward counted as twice the
forward, no recompute) x the samples trained in the traced epochs, over
their wall time and the published peak of the configuration's precision
(``peaks.json``)."""

LAYER = "device"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(rec):
    if not rec["samples"] or not rec["wall_s"] or not rec["kernels"]:
        return None
    flops = 3 * rec["flops_per_sample"] * rec["samples"]
    return 100.0 * flops / rec["wall_s"] / rec["peak_flops_per_s"]
