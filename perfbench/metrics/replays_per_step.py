"""Program replays a training step costs: the strategy's dispatch counter
(``Strategy._dispatches``, one per replayed body) over the traced epochs,
divided by the steps the traffic's schedule gives them."""

LAYER = "engine"
UNIT = "replays"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "train_samples_per_s"


def read(rec):
    if not rec["steps"] or not rec["dispatches"]:
        return None
    return rec["dispatches"] / rec["steps"]
