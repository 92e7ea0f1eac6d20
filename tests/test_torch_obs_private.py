"""Observed private runs in the port against ``repro``, on the CPU, at the
sizes of ``tests/test_obs.py`` (the tiny DenseNet at 16x16, 3 hospitals of
17, 12 and 9 images, batch 4, 2 rounds, compiled engines, no transport).

  * DP-SGD on FL and SL-AM, and DP-SGD plus cut-layer noise on SFLv3,
    under ``noise_multiplier=0`` and ``clip_norm=2`` (the clip runs, no
    gradient noise is drawn; 2 lies between the per-example norms, so
    some are clipped and some not).  The cut noise is injected into both
    packages' ``_leaf_noise`` as a function of the example's shape alone,
    so every example of both packages gets the same draws.  ``clip_frac``
    is equal to the reference's: the test asserts that every per-example
    norm the port's K5 path returned lies at least 1e-4 relative away
    from C, so no norm sits where round-off could move it across the
    clip.  The other taps within the bars of ``tests/test_torch_obs.py``
    (1e-4, norms 1e-4 relative).
  * FL under participation (``tests/test_participation.py``'s schedule
    (0, 1) then (1, 2), no privacy): each round's ``participation`` equal
    to the sampled ids and to the reference's, the unsampled hospital's
    column NaN, every sampled column finite and within the bars above of
    the reference's, ``update_cosine`` included.
  * The split family refuses ``observe`` with participation with the
    reference's ``ValueError``, at construction and per run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.core import participation as JP
from repro.core.strategies import make_strategy as j_make_strategy
from repro.data.synthetic import make_cxr_clients
from repro.obs import Telemetry as JTelemetry
from repro.privacy import PrivacyConfig as JPrivacy
from repro.privacy import dpsgd as JD
from repro_torch import optim as TO
from repro_torch.core.participation import Participation
from repro_torch.core.strategies import make_strategy
from repro_torch.obs import Telemetry
from repro_torch.privacy import PrivacyConfig
from repro_torch.privacy import dpsgd as TD
from torch_grid_pair import adapters, port_state
from torch_obs_pair import observed_pair

torch.set_num_threads(2)

BATCH, LR, EPOCHS, TOL = 4, 1e-3, 2, 1e-4
SIZES = [17, 12, 9]
CLIP = 2.0
STD = 0.5
ROWS = {"fl": dict(noise_multiplier=0.0, clip_norm=CLIP),
        "sl_am": dict(noise_multiplier=0.0, clip_norm=CLIP),
        "sflv3_ac": dict(noise_multiplier=0.0, clip_norm=CLIP,
                         cut_noise_std=STD)}
NORMS = {"grad_norm", "update_norm"}
SCHED = ((0, 1), (1, 2))


@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, train_per_client=SIZES,
                            val_per_client=6, test_per_client=7,
                            image_size=16, n_clients=3)


def _example_noise(shape) -> np.ndarray:
    """Pre-scaled draws of one example's shape (``shape[1:]``), the same
    for every example of the batch: both packages get them whichever key
    or generator they hold, and whether they draw per example (the
    reference's per-example transform) or per batch (the port)."""
    ex = tuple(int(d) for d in shape[1:])
    seed = int(np.prod(ex)) * 31 + len(ex)
    z = STD * np.random.default_rng(seed).standard_normal(ex)
    return np.broadcast_to(z.astype(np.float32), tuple(shape)).copy()


@pytest.mark.parametrize("method", list(ROWS))
def test_private_taps_match_the_reference(monkeypatch, clients, method):
    monkeypatch.setattr(JD, "_leaf_noise", lambda l, lk, s: jnp.asarray(
        _example_noise(l.shape)))
    monkeypatch.setattr(TD, "_leaf_noise", lambda l, gen, s: torch.from_numpy(
        _example_noise(l.shape)))
    norms = []
    clip = TD.clip_accumulate

    def recording(grads, clip_norm):
        out = clip(grads, clip_norm)
        norms.append(out[1].detach().clone())
        return out
    monkeypatch.setattr(TD, "clip_accumulate", recording)
    ja, ta = adapters("tiny", False)
    priv = ROWS[method]
    sj = j_make_strategy(method, ja, lambda: JO.adam(LR), 3,
                         privacy=JPrivacy(**priv), observe=JTelemetry())
    st = make_strategy(method, ta, lambda: TO.adam(LR), 3, device="cpu",
                       privacy=PrivacyConfig(**priv), observe=Telemetry())
    state_j = sj.setup(jax.random.key(0))
    state_t = port_state(method, jax.tree.map(np.asarray, state_j))
    data = [c.train for c in clients]
    sj.run(state_j, data, np.random.default_rng(1), BATCH, EPOCHS)
    st.run(state_t, data, np.random.default_rng(1), BATCH, EPOCHS)
    n = torch.cat(norms).numpy()
    assert len(n) and (np.abs(n - CLIP) >= 1e-4 * CLIP).all()
    rj, rt = sj.last_run_telemetry, st.last_run_telemetry
    assert len(rt.rounds) == len(rj.rounds) == EPOCHS
    fracs = []
    for a, b in zip(rj.rounds, rt.rounds):
        assert set(a.metrics) == set(b.metrics)
        assert "clip_frac" in b.metrics
        assert (method == "fl") != ({"cut_mean", "cut_std",
                                     "cut_absmax"} <= set(b.metrics))
        for k in a.metrics:
            va, vb = np.asarray(a.metrics[k]), np.asarray(b.metrics[k])
            assert va.shape == vb.shape == (3,), k
            if k == "clip_frac":
                np.testing.assert_array_equal(vb, va)
                fracs.extend(vb)
            elif k in NORMS:
                np.testing.assert_allclose(vb, va, rtol=TOL, atol=0,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(vb, va, atol=TOL, rtol=0,
                                           err_msg=k)
    # the clip bit some examples and spared others
    assert 0 < np.mean(fracs) < 1


def test_participation_columns_match_the_reference(clients):
    sj, st = observed_pair(clients, "fl",
                           part=dict(n_global=3, schedule=SCHED))
    rj, rt = sj.last_run_telemetry, st.last_run_telemetry
    assert len(rt.rounds) == len(rj.rounds) == EPOCHS
    for e, (a, b) in enumerate(zip(rj.rounds, rt.rounds)):
        assert b.participation.tolist() == a.participation.tolist() == list(
            SCHED[e])
        assert set(a.metrics) == set(b.metrics)
        assert "update_cosine" in b.metrics
        unsampled = [c for c in range(3) if c not in SCHED[e]][0]
        for k in a.metrics:
            va, vb = np.asarray(a.metrics[k]), np.asarray(b.metrics[k])
            assert vb.shape == (3,) and np.isnan(vb[unsampled]), k
            assert np.isfinite(vb[list(SCHED[e])]).all(), k
            np.testing.assert_array_equal(np.isnan(vb), np.isnan(va))
            ok = ~np.isnan(va)
            if k in NORMS:
                np.testing.assert_allclose(vb[ok], va[ok], rtol=TOL, atol=0,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(vb[ok], va[ok], atol=TOL, rtol=0,
                                           err_msg=k)
        assert b.to_json()["participation"] == list(SCHED[e])


def test_split_family_refuses_observe_with_participation():
    ja, ta = adapters("tiny", False)
    for method in ("sl_am", "sflv2_ac", "sflv3_ac"):
        with pytest.raises(ValueError) as ej:
            j_make_strategy(method, ja, lambda: JO.adam(LR), 3,
                            participation=JP.Participation(n_global=3, k=2),
                            observe=JTelemetry())
        with pytest.raises(ValueError) as et:
            make_strategy(method, ta, lambda: TO.adam(LR), 3, device="cpu",
                          participation=Participation(n_global=3, k=2),
                          observe=Telemetry())
        assert str(et.value) == str(ej.value)


def test_split_family_refuses_an_observed_participating_run(clients):
    _, ta = adapters("tiny", False)
    data = [c.train for c in clients]
    for method in ("sl_am", "sflv3_ac"):
        st = make_strategy(method, ta, lambda: TO.adam(LR), 3, device="cpu",
                           participation=Participation(n_global=3, k=2))
        state = st.setup(0)
        with pytest.raises(ValueError, match="participation with observe"):
            st.run(state, data, np.random.default_rng(1), BATCH, 1,
                   observe=True)
        # unobserved, the same strategy still trains
        _, logs = st.run(state, data, np.random.default_rng(1), BATCH, 1)
        assert logs and logs[0].telemetry is None
