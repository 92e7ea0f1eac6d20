"""Host milliseconds an epoch spends copying its inputs to the card: the
program's ``h2d`` span (the epoch's batch buffers and round tables, from
pageable host memory, inside ``dispatch``), read from the strategy's
tracer over the traced epochs."""

LAYER = "engine"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_samples_per_s"


def read(rec):
    spans = rec["program_spans"].get("h2d", [])
    if not spans or not rec["epochs"]:
        return None
    return 1e3 * sum(spans) / rec["epochs"]
