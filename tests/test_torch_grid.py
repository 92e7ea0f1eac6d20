"""Every row of the paper's Table-2 grid (``benchmarks/repro_tables.ROWS``)
in the port against ``repro``, on the CPU, stepwise: the tiny DenseNet of
``tests/test_system.py`` at 16x16, 5 synthetic hospitals of 32 images,
batch 8, Adam at the paper's 1e-4, the split family over an identity
link (no quantisation, so nothing lands on another int8 level; the int8
link is ``test_torch_grid_wire.py``'s).

Both packages start from the same converted weights and draw the same
numpy batches.  Tolerances (float32 round-off of convolutions summed in
another order):
  * the first 2 steps' losses: <= 1e-4;
  * every param after one epoch (the clients, the server, or the global
    model): <= 1e-6, 1% of lr, so every Adam update agrees within 1% of
    its size and a dropped or extra step (a move of up to lr) fails; sound
    readings are at most 3.6e-7;
  * the same after one epoch over hospitals of 32, 8, 24, 16 and 40
    images, for the rows whose epoch ends in a mean (FL weights it by
    sample count, SFLv2/v1 do not), so that the two means differ;
  * AUROC on the test split after 2 epochs, for FL, SL_NLS_AM and
    SFLv2_LS_AC: |difference| <= 0.05 (DESIGN.md §13's task-level bar).
"""

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_cxr_clients
from torch_grid_pair import (client_trees, flat, load, param_pairs,
                             port_state, run_pair)

torch.set_num_threads(2)

BATCH, LR, TOL = 8, 1e-4, 1e-4
PARAM_TOL = 0.01 * LR
ROWS = load("benchmarks/repro_tables.py").ROWS
TWO_EPOCHS = ("FL", "SL_NLS_AM", "SFLv2_LS_AC")
LABELS = [r[0] for r in ROWS]
# rows whose epoch ends in a mean of hospital trees
MEANS = [r for r in ROWS if r[1] in ("fl", "sflv2_ac", "sflv1_ac")]


@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, train_per_client=32, val_per_client=16,
                            test_per_client=16, image_size=16)


@pytest.fixture(scope="module")
def runs(clients):
    out = {}
    for label, method, nls in ROWS:
        codec = None if method in ("centralized", "fl") else "identity"
        out[label] = run_pair(method, nls, "tiny", clients, BATCH, LR,
                              codec, epochs=2 if label in TWO_EPOCHS else 1)
        out[label]["method"] = method
    return out


def test_the_tool_runs_the_reference_rows():
    assert load("tools/repro_tables_torch.py").ROWS == ROWS


@pytest.mark.parametrize("label", LABELS)
def test_first_steps_match_repro(runs, label):
    r = runs[label]
    lj, lt = r["logs_j"][0], r["logs_t"][0]
    assert lt.steps == lj.steps
    assert lt.client_steps == lj.client_steps
    assert lt.weights == lj.weights
    per_step = len(lj.losses) // lj.steps
    first = slice(0, 2 * per_step)
    assert np.isfinite(lt.losses).all()
    np.testing.assert_allclose(lt.losses[first], lj.losses[first], atol=TOL,
                               rtol=0)


def assert_params_match(method, state_j, state_t):
    for tj, tt in param_pairs(method, state_j, state_t):
        fj, ft = flat(tj), flat(tt)
        assert list(fj) == list(ft)
        for k in fj:
            np.testing.assert_allclose(ft[k], fj[k], atol=PARAM_TOL, rtol=0,
                                       err_msg=str(k))


@pytest.mark.parametrize("label", LABELS)
def test_params_after_one_epoch_match_repro(runs, label):
    r = runs[label]
    assert_params_match(r["method"], r["states_j"][0], r["states_t"][0])


@pytest.mark.parametrize("label,method,nls", MEANS,
                         ids=[r[0] for r in MEANS])
def test_means_over_unequal_hospitals_match_repro(label, method, nls):
    """FedAvg's sample-count weights and SFLv2/v1's unweighted mean (of
    the tail too under NLS) differ when the hospitals do: every param
    after the epoch's mean within 1% of lr of the reference's."""
    uneven = make_cxr_clients(seed=0, train_per_client=[32, 8, 24, 16, 40],
                              val_per_client=4, test_per_client=4,
                              image_size=16)
    codec = None if method == "fl" else "identity"
    r = run_pair(method, nls, "tiny", uneven, BATCH, LR, codec)
    assert r["logs_t"][0].weights == r["logs_j"][0].weights
    assert_params_match(method, r["states_j"][0], r["states_t"][0])


@pytest.mark.parametrize("label", [l for l in LABELS
                                   if l not in ("Centralized", "FL")])
def test_client_sync_follows_the_method(runs, label):
    """SFLv2/v1 end the epoch with every hospital holding the mean client
    tree(s) (the tail too under NLS); SL/SFLv3 keep them distinct."""
    r = runs[label]
    trees = [flat(t) for t in client_trees(r["states_t"][0])]
    synced = r["method"].startswith(("sflv2", "sflv1"))
    same = [all(np.array_equal(t[k], trees[0][k]) for k in trees[0])
            for t in trees[1:]]
    assert all(same) if synced else not any(same)
    assert any(k[0] == "tail" for k in trees[0]) == ("NLS" in label)


@pytest.mark.parametrize("label", TWO_EPOCHS)
def test_auroc_after_two_epochs_matches_repro(runs, clients, label):
    r = runs[label]
    mj = r["sj"].evaluate(r["states_j"][1], clients)
    mt = r["st"].evaluate(r["states_t"][1], clients)
    assert list(mt) == list(mj)
    assert abs(mt["auroc"] - mj["auroc"]) <= 0.05
    np.testing.assert_allclose(
        r["st"].val_loss(r["states_t"][1], clients),
        r["sj"].val_loss(r["states_j"][1], clients), atol=TOL, rtol=0)


def test_run_is_the_per_epoch_loop(runs, clients):
    """``Strategy.run`` gives the same logs and state as two
    ``run_epoch`` calls from the same start and rng."""
    r = runs["SFLv2_LS_AC"]
    st, start = r["st"], r["sj"].setup(jax.random.key(0))
    state, logs = st.run(port_state("sflv2_ac", start),
                         [c.train for c in clients],
                         np.random.default_rng(1), BATCH, 2)
    assert [l.losses for l in logs] == [l.losses for l in r["logs_t"]]
    for a, b in zip(client_trees(state), client_trees(r["states_t"][1])):
        fa, fb = flat(a), flat(b)
        assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    assert st.run(state, [c.train for c in clients],
                  np.random.default_rng(1), BATCH, 0) == (state, [])
    # observe= is ported (M10): an observed run fills the telemetry
    _, observed = st.run(state, [c.train for c in clients],
                         np.random.default_rng(1), BATCH, 1, observe=True)
    assert observed[0].telemetry is st.last_run_telemetry.rounds[0]
