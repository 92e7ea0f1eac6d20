"""Host milliseconds an epoch spends in the validation pass: the program's
``val_loss`` span (``Strategy.val_loss``, eager, a copy to the card a
batch), read from the strategy's tracer over the traced epochs."""

LAYER = "strategy loop"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_samples_per_s"


def read(rec):
    spans = rec["program_spans"].get("val_loss", [])
    if not spans or not rec["epochs"]:
        return None
    return 1e3 * sum(spans) / rec["epochs"]
