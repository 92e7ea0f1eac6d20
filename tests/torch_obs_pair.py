"""Shared by ``tests/test_torch_obs_eps*.py``: one observed run of a grid
method in the reference and in the port on the CPU, both compiled, from
the reference's ``setup(key(0))`` converted by ``repro_torch.interop`` and
the same numpy batch order, with the same privacy and participation."""

import jax
import numpy as np

from repro import optim as JO
from repro.core import participation as JP
from repro.core.strategies import make_strategy as j_make_strategy
from repro.obs import Telemetry as JTelemetry
from repro.privacy import PrivacyConfig as JPrivacy
from repro_torch import optim as TO
from repro_torch.core.participation import Participation
from repro_torch.core.strategies import make_strategy
from repro_torch.obs import Telemetry
from repro_torch.privacy import PrivacyConfig
from torch_grid_pair import adapters, port_state

BATCH, LR, EPOCHS = 4, 1e-3, 2
DP = dict(noise_multiplier=1.1, clip_norm=1.0)


def observed_pair(clients, method, privacy=None, part=None):
    """``EPOCHS`` observed rounds of ``method`` at batch ``BATCH`` in both
    packages; ``privacy`` and ``part`` the ``PrivacyConfig`` and
    ``Participation`` keywords.  Returns (reference, port) strategies."""
    ja, ta = adapters("tiny", False)
    sj = j_make_strategy(method, ja, lambda: JO.adam(LR), len(clients),
                         privacy=privacy and JPrivacy(**privacy),
                         participation=part and JP.Participation(**part),
                         observe=JTelemetry())
    st = make_strategy(method, ta, lambda: TO.adam(LR), len(clients),
                       device="cpu",
                       privacy=privacy and PrivacyConfig(**privacy),
                       participation=part and Participation(**part),
                       observe=Telemetry())
    state_j = sj.setup(jax.random.key(0))
    state_t = port_state(method, jax.tree.map(np.asarray, state_j))
    data = [c.train for c in clients]
    sj.run(state_j, data, np.random.default_rng(1), BATCH, EPOCHS)
    st.run(state_t, data, np.random.default_rng(1), BATCH, EPOCHS)
    return sj, st


def assert_epsilon_series(sj, st, part=None):
    """Every round's epsilon row equal to the reference's, increasing, the
    last equal to the port's ``privacy_report``, at most 5 steps per
    sampling rate; under participation the rounds' sampled ids equal."""
    rj, rt = sj.last_run_telemetry, st.last_run_telemetry
    assert len(rt.rounds) == len(rj.rounds) == EPOCHS
    prev = np.zeros(len(rt.rounds[0].epsilon))
    for a, b in zip(rj.rounds, rt.rounds):
        np.testing.assert_array_equal(b.epsilon, a.epsilon)
        assert (b.epsilon > prev).all()
        prev = b.epsilon
        cf = np.asarray(b.metrics["clip_frac"])
        assert ((cf[~np.isnan(cf)] >= 0) & (cf[~np.isnan(cf)] <= 1)).all()
    report = st.privacy_report()
    assert [x["steps"] for x in report] == [
        x["steps"] for x in sj.privacy_report()]
    assert all(x["steps"] <= 5 for x in report)
    np.testing.assert_array_equal(rt.rounds[-1].epsilon,
                                  [x["epsilon"] for x in report])
    if part is not None:
        for a, b in zip(rj.rounds, rt.rounds):
            assert b.participation.tolist() == a.participation.tolist()
            assert len(b.participation) == part["k"]
