"""The readers of the program's own spans (``h2d``, ``val_loss``,
``replay.*`` within ``dispatch``) on a synthetic record, and their silence
where a program records none of them."""

import pytest

from perfbench import harness

# two epochs, each a ``dispatch`` span (us on the profiler's clock) holding
# its replays: gaps of 10 + 5 us in the first, 20 us in the second; the
# 1000 us between the two dispatches, and the replay that starts outside
# both, are no gap of a run
SPANS = [("run_epoch", 0.0, 400.0), ("dispatch", 0.0, 300.0),
         ("h2d", 10.0, 40.0),
         ("replay.begin", 50.0, 60.0), ("replay.step", 70.0, 170.0),
         ("replay.round", 175.0, 180.0),
         ("val_loss", 320.0, 390.0),
         ("replay.step", 700.0, 800.0),
         ("dispatch", 1300.0, 1600.0), ("h2d", 1310.0, 1330.0),
         ("replay.step", 1340.0, 1440.0), ("replay.step", 1460.0, 1560.0)]


def record(spans=SPANS):
    program = {}
    for name, a, b in spans:
        if name != "run_epoch":
            program.setdefault(name, []).append((b - a) / 1e6)
    return {"spans": spans, "program_spans": program, "epochs": 2,
            "steps": 4}


@pytest.mark.parametrize("name, value", [
    ("h2d_ms_per_epoch", 1e-3 * (30 + 20) / 2),
    ("val_ms_per_epoch", 1e-3 * 70 / 2),
    # four step replays of 100 us over the 4 steps
    ("step_device_ms", 1e-3 * 400 / 4),
    ("replay_gap_ms_per_epoch", 1e-3 * (10 + 5 + 20) / 2)])
def test_program_span_readers(name, value):
    assert harness.module("metrics", name).read(record()) == pytest.approx(
        value)


@pytest.mark.parametrize("name, drop", [
    ("h2d_ms_per_epoch", ("h2d",)),
    ("val_ms_per_epoch", ("val_loss",)),
    ("step_device_ms", ("replay.step",)),
    ("replay_gap_ms_per_epoch", ("replay.begin", "replay.step",
                                 "replay.round")),
    ("replay_gap_ms_per_epoch", ("dispatch",))])
def test_program_span_readers_find_nothing(name, drop):
    """A program without the span (the parent of this metric's PR) reads
    None, and raises nothing."""
    rec = record([s for s in SPANS if s[0] not in drop])
    assert harness.module("metrics", name).read(rec) is None
