"""SL-AM and SFLv3-AC on ``UNET_MINI`` in the port against ``repro``, LS
and NLS, on the CPU, stepwise over ``Transport("int8")`` fused (K3's plain
version here): 5 synthetic hospitals of 8 images at 32x32, batch 4.  The
LS boundary is the U-Net's pytree (hidden, skip); under NLS the server's
output crosses back through the codec to each hospital's tail.

Both packages start from the same converted weights and draw the same
numpy batches.  The first 2 steps' losses are held within 1e-4 (later
steps are not, for the int8 reason ``test_torch_grid_wire.py`` gives);
wire bytes, step counts and each epoch's schedule signature exactly
equal.
"""

import numpy as np
import pytest
import torch

from repro.data.synthetic import make_cxr_clients
from repro_torch import optim as TO
from repro_torch.core.strategies import make_strategy
from torch_grid_pair import adapters, load, run_pair

torch.set_num_threads(2)

BATCH, LR, TOL = 4, 1e-4, 1e-4
ROWS = load("benchmarks/repro_tables.py").ROWS
CASES = [("sl_am", False), ("sl_am", True), ("sflv3_ac", False),
         ("sflv3_ac", True)]
IDS = [f"{m}-{'NLS' if nls else 'LS'}" for m, nls in CASES]


@pytest.fixture(scope="module")
def runs():
    clients = make_cxr_clients(seed=0, train_per_client=2 * BATCH,
                               val_per_client=4, test_per_client=4,
                               image_size=32)
    return {case: run_pair(*case, "unet-mini", clients, BATCH, LR, "int8")
            for case in CASES}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_first_steps_match_repro(runs, case):
    lj, lt = runs[case]["logs_j"][0], runs[case]["logs_t"][0]
    assert (lt.steps, lt.client_steps) == (lj.steps, lj.client_steps)
    first = slice(0, 2 * len(lj.losses) // lj.steps)
    assert np.isfinite(lt.losses).all()
    np.testing.assert_allclose(lt.losses[first], lj.losses[first], atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_wire_bytes_equal_repro(runs, case):
    tj, tt = runs[case]["tj"], runs[case]["tt"]
    assert tt.summary() == tj.summary() and tt.bytes_on_wire > 0
    ej, et = tj.epoch_log[0], tt.epoch_log[0]
    assert (et.kind, et.schedule, et.tr_counts, et.legs, et.nls) == \
        (ej.kind, ej.schedule, ej.tr_counts, ej.legs, ej.nls)
    assert et.legs["act_mt"] > 0 if case[1] else et.legs["act_mt"] == 0


@pytest.mark.parametrize("label, method, nls", ROWS, ids=[r[0] for r in ROWS])
def test_every_row_trains_and_evaluates_on_the_unet(label, method, nls):
    """The port alone: one epoch of every Table-2 row on ``UNET_MINI`` at
    16x16 gives finite losses and metrics, and the client sync of SFLv2/v1
    covers the tail under NLS."""
    clients = make_cxr_clients(seed=0, train_per_client=2 * BATCH,
                               val_per_client=4, test_per_client=12,
                               image_size=16)
    st = make_strategy(method, adapters("unet-mini", nls)[1],
                       lambda: TO.adam(LR), len(clients), device="cpu")
    state, log = st.run_epoch(st.setup(0), [c.train for c in clients],
                              np.random.default_rng(0), BATCH)
    assert log.steps > 0 and np.isfinite(log.losses).all()
    assert all(np.isfinite(v) for v in st.evaluate(state, clients).values())
    if method.startswith(("sflv2", "sflv1")) and nls:
        tails = [c["tail"]["head"]["c"]["w"] for c in state["clients"]]
        assert all(torch.equal(t, tails[0]) for t in tails)
