"""Samples (images, sequences) trained per second: every sample of the
window's whole epochs (SplitFedv3: steps x hospitals x batch, the smaller
hospitals wrapping around) over the host time from the first epoch's
start to the last epoch's validation loss."""

UNIT = "samples/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(rec):
    return rec["samples"] / rec["window_s"]
