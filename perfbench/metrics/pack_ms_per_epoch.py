"""Host milliseconds an epoch spends in the program's ``pack`` span (the
pad-and-mask packing of the epoch's batches on the host), read from the
strategy's tracer over the traced epochs."""

LAYER = "strategy loop"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_samples_per_s"


def read(rec):
    packs = rec["program_spans"].get("pack", [])
    if not packs or not rec["epochs"]:
        return None
    return 1e3 * sum(packs) / rec["epochs"]
