"""The share of the traced epochs' wall time in which no kernel ran on the
card: 1 - the union of the kernels' intervals over the wall time."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(rec):
    if not rec["busy_s"] or not rec["wall_s"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["wall_s"])
