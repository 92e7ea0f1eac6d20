"""In-program telemetry (``repro_torch.obs.telemetry``) in the port against
``repro``, on the CPU, at the sizes of ``tests/test_obs.py``: the tiny
DenseNet at 16x16, 3 hospitals of 17, 12 and 9 images, batch 4, Adam at
1e-3, 2 rounds, no transport (the cut statistics read the raw payload), both
packages from the same converted weights and the same numpy batch order.

  * every method of ``METHODS`` on both packages' compiled engines: the
    port's ``RunTelemetry`` against the reference's — the same rounds, key
    sets and shapes; ``loss``, the cut statistics and ``update_cosine``
    within 1e-4, ``grad_norm`` and ``update_norm`` within 1e-4 relative;
  * within the port, on both engines: observed params bit-equal to
    unobserved ones, the same replay (dispatch) count, compiled against
    stepwise within 1e-4 (the reference's own bar), rows of 3 hospitals
    (centralized 1) all finite, ``EpochLog.telemetry`` the run's rounds;
    an observed program cached apart from the unobserved one (each
    captured once, none recaptured); the ``run(observe=)`` override, the
    flag subsets and ``step_keys``.
"""

import jax
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.core.strategies import make_strategy as j_make_strategy
from repro.data.synthetic import make_cxr_clients
from repro.obs import Telemetry as JTelemetry
from repro_torch import optim as TO
from repro_torch.core.strategies import METHODS, make_strategy
from repro_torch.obs import Telemetry, as_telemetry
from repro_torch.tree import tree_leaves
from torch_grid_pair import adapters, port_state

torch.set_num_threads(2)

BATCH, LR, EPOCHS, TOL = 4, 1e-3, 2, 1e-4
SIZES = [17, 12, 9]
CUT = {"cut_mean", "cut_std", "cut_absmax"}
NORMS = {"grad_norm", "update_norm"}


@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, train_per_client=SIZES,
                            val_per_client=6, test_per_client=7,
                            image_size=16, n_clients=3)


@pytest.fixture(scope="module")
def adapter_pair():
    return adapters("tiny", False)


def _port_run(method, ta, clients, engine, observe, start=None):
    st = make_strategy(method, ta, lambda: TO.adam(LR), len(clients),
                       engine=engine, device="cpu",
                       observe=Telemetry() if observe else None)
    state = st.setup(0) if start is None else start
    state, logs = st.run(state, [c.train for c in clients],
                         np.random.default_rng(1), BATCH, EPOCHS)
    leaves = [l.clone() for i in range(len(clients))
              for l in tree_leaves(st.params_for_eval(state, i))]
    return dict(st=st, leaves=leaves, logs=logs, rt=st.last_run_telemetry,
                dispatches=st._dispatches)


@pytest.fixture(scope="module")
def ref_pairs(clients, adapter_pair):
    """Per method: the reference's and the port's observed compiled runs
    from the same converted start."""
    ja, ta = adapter_pair
    out = {}
    for method in METHODS:
        sj = j_make_strategy(method, ja, lambda: JO.adam(LR), len(clients),
                             observe=JTelemetry())
        state_j = sj.setup(jax.random.key(0))
        start = port_state(method, jax.tree.map(np.asarray, state_j))
        sj.run(state_j, [c.train for c in clients],
               np.random.default_rng(1), BATCH, EPOCHS)
        out[method] = (sj.last_run_telemetry,
                       _port_run(method, ta, clients, "compiled", True,
                                 start)["rt"])
    return out


@pytest.mark.parametrize("method", METHODS)
def test_taps_match_the_reference(ref_pairs, method):
    rj, rt = ref_pairs[method]
    assert (rt.strategy, rt.n_clients) == (rj.strategy, rj.n_clients)
    assert len(rt.rounds) == len(rj.rounds) == EPOCHS
    for a, b in zip(rj.rounds, rt.rounds):
        assert a.round_index == b.round_index
        assert set(a.metrics) == set(b.metrics)
        assert a.epsilon is None and b.epsilon is None
        for k in a.metrics:
            va, vb = np.asarray(a.metrics[k]), np.asarray(b.metrics[k])
            assert va.shape == vb.shape, k
            if k in NORMS:
                np.testing.assert_allclose(vb, va, rtol=TOL, atol=0,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(vb, va, atol=TOL, rtol=0,
                                           err_msg=k)


def test_the_port_reports_every_tap_of_its_family(ref_pairs):
    for method, (_, rt) in ref_pairs.items():
        keys = set(rt.rounds[0].metrics)
        assert {"loss"} | NORMS <= keys
        assert ("update_cosine" in keys) == (method == "fl")
        assert (CUT <= keys) == (method not in ("centralized", "fl"))
        cos = rt.metric("update_cosine")
        assert (np.abs(cos[np.isfinite(cos)]) <= 1.0 + 1e-6).all()


# ---------------------------------------------------------------------------
# within the port: observation changes nothing, both engines agree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_runs(clients, adapter_pair):
    _, ta = adapter_pair
    return {(m, e, o): _port_run(m, ta, clients, e, o)
            for m in METHODS for e in ("compiled", "stepwise")
            for o in (False, True)}


@pytest.mark.parametrize("engine", ["compiled", "stepwise"])
@pytest.mark.parametrize("method", METHODS)
def test_observed_params_bit_equal(port_runs, method, engine):
    off, on = port_runs[(method, engine, False)], port_runs[(method, engine,
                                                             True)]
    assert len(off["leaves"]) == len(on["leaves"])
    for a, b in zip(off["leaves"], on["leaves"]):
        assert torch.equal(a, b)
    assert off["dispatches"] == on["dispatches"] > 0
    assert [l.losses for l in off["logs"]] == [l.losses for l in on["logs"]]
    assert off["rt"] is None and all(l.telemetry is None
                                     for l in off["logs"])


@pytest.mark.parametrize("method", METHODS)
def test_compiled_telemetry_matches_stepwise(port_runs, method):
    rc = port_runs[(method, "compiled", True)]
    rs = port_runs[(method, "stepwise", True)]
    n_rows = 1 if method == "centralized" else len(SIZES)
    assert len(rc["rt"].rounds) == len(rs["rt"].rounds) == EPOCHS
    assert [l.telemetry for l in rc["logs"]] == rc["rt"].rounds
    for i, (a, b) in enumerate(zip(rc["rt"].rounds, rs["rt"].rounds)):
        assert a.round_index == b.round_index == i
        assert set(a.metrics) == set(b.metrics)
        for k in a.metrics:
            assert np.asarray(a.metrics[k]).shape == (n_rows,), k
            assert np.isfinite(a.metrics[k]).all(), k
            np.testing.assert_allclose(a.metrics[k], b.metrics[k],
                                       atol=TOL, err_msg=k)


def test_observed_programs_are_cached_apart(clients, adapter_pair):
    """An observed run builds its own program beside the unobserved one;
    running both again builds and captures nothing new."""
    _, ta = adapter_pair
    st = make_strategy("sflv3_ac", ta, lambda: TO.adam(LR), 3, device="cpu")
    state = st.setup(0)
    data = [c.train for c in clients]
    for observe in (None, True, None, Telemetry()):
        st.run(state, data, np.random.default_rng(1), BATCH, 1,
               observe=observe)
    progs = list(st._programs.values())
    assert len(progs) == 2
    assert sorted(len(p.metrics) for p in progs) == [0, 5]
    assert [p.calls["begin"] for p in progs] == [2, 2]


# ---------------------------------------------------------------------------
# spec plumbing: make_strategy(observe=), run(observe=), as_telemetry
# ---------------------------------------------------------------------------

def test_as_telemetry_normalization():
    assert as_telemetry(None) is None
    assert as_telemetry(False) is None
    assert as_telemetry(True) == Telemetry()
    t = Telemetry(cut_stats=False)
    assert as_telemetry(t) is t
    off = Telemetry(loss=False, norms=False, update_cosine=False,
                    cut_stats=False, clip_fraction=False, epsilon=False)
    assert as_telemetry(off) is None
    with pytest.raises(TypeError):
        as_telemetry("yes")


@pytest.mark.parametrize("engine", ["compiled", "stepwise"])
def test_run_observe_override(clients, adapter_pair, engine):
    """run(observe=) overrides the constructor spec per run: False turns
    it off, None inherits, a Telemetry turns it on."""
    _, ta = adapter_pair
    data = [c.train for c in clients]
    st = make_strategy("fl", ta, lambda: TO.adam(LR), 3, engine=engine,
                       device="cpu", observe=Telemetry())
    state = st.setup(0)
    state, logs = st.run(state, data, np.random.default_rng(0), BATCH, 1,
                         observe=False)
    assert st.last_run_telemetry is None and logs[0].telemetry is None
    state, logs = st.run(state, data, np.random.default_rng(0), BATCH, 1)
    assert logs[0].telemetry is st.last_run_telemetry.rounds[0]
    plain = make_strategy("fl", ta, lambda: TO.adam(LR), 3, engine=engine,
                          device="cpu")
    state = plain.setup(0)
    plain.run(state, data, np.random.default_rng(0), BATCH, 1,
              observe=Telemetry(update_cosine=False))
    assert set(plain.last_run_telemetry.rounds[0].metrics) == {
        "loss"} | NORMS
    plain.run(state, data, np.random.default_rng(0), BATCH, 1)
    assert plain.last_run_telemetry is None


@pytest.mark.parametrize("engine", ["compiled", "stepwise"])
def test_telemetry_flag_subsets(clients, adapter_pair, engine):
    """Disabled taps are absent: the key set is static per spec."""
    _, ta = adapter_pair
    st = make_strategy("sl_am", ta, lambda: TO.adam(LR), 3, engine=engine,
                       device="cpu")
    state = st.setup(0)
    spec = Telemetry(norms=False, cut_stats=False)
    st.run(state, [c.train for c in clients], np.random.default_rng(0),
           BATCH, 1, observe=spec)
    assert set(st.last_run_telemetry.rounds[0].metrics) == {"loss"}
    assert spec.step_keys(dp=False, cut=True) == ()
    assert Telemetry().step_keys(dp=True, cut=True) == (
        "grad_norm", "update_norm", "cut_mean", "cut_std", "cut_absmax",
        "clip_frac")
    assert Telemetry().step_keys(dp=False, cut=False) == (
        "grad_norm", "update_norm")
    assert Telemetry(norms=False).step_keys(dp=True, cut=False) == (
        "clip_frac",)


def test_shard_observes_as_unplaced(adapter_pair, clients):
    """``shard=True`` with ``observe=True`` on one device places nothing:
    the run and its telemetry are the unplaced run's, bit for bit."""
    _, ta = adapter_pair
    a = _port_run("fl", ta, clients, "compiled", True)
    st = make_strategy("fl", ta, lambda: TO.adam(LR), 3, device="cpu",
                       shard=True, observe=True)
    assert not st.placement.enabled and not st.placement.padded
    state, _ = st.run(st.setup(0), [c.train for c in clients],
                      np.random.default_rng(1), BATCH, EPOCHS)
    assert all(torch.equal(x, y) for x, y in zip(
        a["leaves"], tree_leaves(st.params_for_eval(state, 0))))
    for ra, rb in zip(a["rt"].rounds, st.last_run_telemetry.rounds):
        for k in ra.metrics:
            np.testing.assert_array_equal(ra.metrics[k], rb.metrics[k])
