"""Device milliseconds an epoch lies idle between the program's replays:
within each ``dispatch`` span, the time from one ``replay.*`` span's end
to the next one's start (the replays' CUDA-event stamps on the tracer's
clock), summed over the traced epochs and divided by them.  A replay
that starts outside every ``dispatch`` span does not count."""

LAYER = "engine"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_samples_per_s"


def read(rec):
    replays = sorted((a, b) for n, a, b in rec["spans"]
                     if n.startswith("replay."))
    if not replays or not rec["epochs"]:
        return None
    dispatches = [(lo, hi) for n, lo, hi in rec["spans"] if n == "dispatch"]
    if not dispatches:
        return None
    gap_us = 0.0
    for lo, hi in dispatches:
        inside = [(a, b) for a, b in replays if lo <= a <= hi]
        gap_us += sum(max(a - end, 0.0) for (_, end), (a, _) in
                      zip(inside, inside[1:]))
    return gap_us / 1e3 / rec["epochs"]
