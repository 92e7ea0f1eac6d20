"""Seconds from the process's start to the window's: imports, the data and
weights, the strategy, and its first epoch with its validation loss,
which the check follows and which captures the graphs (and, on a
checkout's first run, builds the kernels)."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(rec):
    return rec["setup_s"]
