"""Device milliseconds of a training step: the program's ``replay.step``
spans (each step body's replay, timed on the card by a pair of CUDA
events), summed over the traced epochs and divided by the steps the
traffic's schedule gives them."""

LAYER = "engine"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_samples_per_s"


def read(rec):
    spans = rec["program_spans"].get("replay.step", [])
    if not spans or not rec["steps"]:
        return None
    return 1e3 * sum(spans) / rec["steps"]
