"""A model family added as files alone: the ``lm_dense`` family
(``families/lm_dense/``, no cell) drives the port's LM SplitFedv3 step
(``make_sflv3_train_step(..., compress=True)``) through ``harness.run`` on
a mini cell on the CPU to ``correct``, and the faults planted in the
reference's place (``control.readings``) each fail one of its numbers.

The limits are this test's own, set from CPU readings over six seeds (1,
77, 99, 12345, 2**33 + 5, 2**40 + 3): the program's largest and the
smallest of the int8 link left out, the nearest fault, each number's
limit between them.  The program reads above rounding because an ulp
before the int8 link can move a value by a level."""

import pytest
import torch

from conftest import lm_parts

from perfbench import control, harness

LIMITS = {
    # sound runs 8.4e-06 at most; no link 2.2e-04 at least
    "loss_gap": 5e-05,
    # sound runs 2.6e-05; no link 3.3e-04
    "epoch_loss_gap": 1.5e-04,
    # sound runs 2.3e-04; no link 1.75e-03
    "moment_gap": 1e-03,
    # sound runs 3.6e-05; no link 1.0e-03
    "update_gap": 3e-04,
    # sound runs 3.6e-06; no link 3.9e-05
    "val_gap": 2e-05,
}
SEED = 2 ** 33 + 5


def test_lm_run_is_correct(cpu_threads):
    out = harness.run("mini", SEED, 0.1, False, 0.0, device="cpu",
                      b=harness.bench(), parts=lm_parts(LIMITS))
    assert out["correct"], out["checks"]
    # four steps an epoch, one loss a step (the mean over hospitals)
    assert out["attempted"] % 4 == 0 and out["failed"] == 0
    assert out["metrics"]["train_samples_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["half", "no_link", "frozen"])
def test_lm_fault_fails_a_number(fault, cpu_threads):
    r = control.readings(lm_parts(LIMITS), SEED, ("program", fault),
                         torch.device("cpu"))
    assert all(r["program"][k] <= LIMITS[k] for k in harness.CHECKS)
    assert any(r[fault][k] > LIMITS[k] for k in harness.CHECKS), r[fault]
