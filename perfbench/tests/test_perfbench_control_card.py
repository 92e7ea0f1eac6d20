"""The control on the card, at the cells' own sizes (the first epoch of
the cell's layout): the program's readings are inside a cell's limits and
the reference in TF32, the control, is outside at least one of them.
Skips without a CUDA card (``python3 perfbench/control.py`` takes more
seeds)."""

import pytest

from perfbench import control, harness

CELLS = ["densenet121.sflv3.fp32", "unet768.sflv3.fp32"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(workload, card):
    parts = harness.cell(workload, harness.bench())
    limits = parts[3]
    r = control.readings(parts, 1_000_003, ("program", "tf32"), card)
    assert all(r["program"][k] <= limits[k] for k in harness.CHECKS)
    assert any(r["tf32"][k] > limits[k] for k in harness.CHECKS)
