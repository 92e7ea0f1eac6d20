"""Peak device memory over set-up and window,
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at the start of set-up, in GiB."""

UNIT = "GiB"
BETTER = "lower"
SOURCE = "device_trace"


def read(rec):
    return rec["peak_bytes"] / 2 ** 30
