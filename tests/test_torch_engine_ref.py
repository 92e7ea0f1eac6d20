"""The port's compiled engine against the reference's compiled engine, on
the CPU: SFLv3, FL and SL-AM from the same converted weights and the same
numpy batch order (``tests/torch_grid_pair.py`` with ``engine=
"compiled"`` on both sides), on the tiny DenseNet of
``tests/test_system.py`` at 16x16, 5 hospitals of 32, 8, 24, 16 and 40
images (unequal, so FedAvg's weights and SL-AM's drop-outs matter), batch
8, Adam at the paper's 1e-4, the split rows over an identity link.

Tolerances, as for the stepwise grid (``tests/test_torch_grid.py``):
  * the first 2 steps' losses: <= 1e-4;
  * every param after one epoch: <= 1e-6, 1% of lr, so every Adam update
    agrees within 1% of its size and a dropped or extra step fails;
  * the packed epochs, step counts and loss weights: exactly equal.
"""

import numpy as np
import pytest
import torch

from repro.core.strategies import engine as JENG
from repro.data.synthetic import make_cxr_clients
from repro_torch.core.strategies import engine as ENG
from torch_grid_pair import flat, param_pairs, run_pair

torch.set_num_threads(2)

BATCH, LR, TOL = 8, 1e-4, 1e-4
PARAM_TOL = 0.01 * LR
ROWS = [("sflv3_ac", False), ("fl", False), ("sl_am", False),
        ("sl_am", True)]


@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, train_per_client=[32, 8, 24, 16, 40],
                            val_per_client=8, test_per_client=8,
                            image_size=16)


@pytest.fixture(scope="module")
def runs(clients):
    return {(m, nls): run_pair(m, nls, "tiny", clients, BATCH, LR,
                               None if m == "fl" else "identity",
                               engine="compiled")
            for m, nls in ROWS}


@pytest.mark.parametrize("method, nls", ROWS)
def test_compiled_port_matches_compiled_reference(runs, method, nls):
    r = runs[(method, nls)]
    assert r["sj"].engine == r["st"].engine == "compiled"
    lj, lt = r["logs_j"][0], r["logs_t"][0]
    assert (lt.steps, lt.weights, lt.client_steps) == (
        lj.steps, lj.weights, lj.client_steps)
    per_step = len(lj.losses) // lj.steps
    first = slice(0, 2 * per_step)
    np.testing.assert_allclose(lt.losses[first], lj.losses[first], atol=TOL,
                               rtol=0)
    assert np.isfinite(lt.losses).all()
    for tj, tt in param_pairs(method, r["states_j"][0], r["states_t"][0]):
        fj, ft = flat(tj), flat(tt)
        assert list(fj) == list(ft)
        for k in fj:
            np.testing.assert_allclose(ft[k], fj[k], atol=PARAM_TOL, rtol=0,
                                       err_msg=str(k))
    if r["tt"] is not None:
        assert r["tt"].bytes_on_wire == r["tj"].bytes_on_wire


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_pack_epoch_is_the_references(clients, drop_remainder):
    data = [c.train for c in clients]
    pj = JENG.pack_epoch(data, 12, np.random.default_rng(4), drop_remainder)
    pt = ENG.pack_epoch(data, 12, np.random.default_rng(4), drop_remainder)
    assert pt.n_batches == pj.n_batches and pt.n_samples == pj.n_samples
    assert pt.step_examples == pj.step_examples
    np.testing.assert_array_equal(pt.mask, pj.mask)
    if drop_remainder:
        assert pt.ex_weights is None and pj.ex_weights is None
    else:
        np.testing.assert_array_equal(pt.ex_weights, pj.ex_weights)
    assert list(pt.batches) == list(pj.batches)
    for k in pj.batches:
        np.testing.assert_array_equal(pt.batches[k], pj.batches[k])
