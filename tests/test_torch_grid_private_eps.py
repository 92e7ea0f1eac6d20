"""Epsilon and the private options of ``make_strategy`` across the grid, in
the port against ``repro``, on the CPU.

  * ``privacy_report()`` after one stepwise epoch under
    ``PrivacyConfig(noise_multiplier=1.1, clip_norm=1.0)`` equal to the
    reference's, exactly, on centralized (every hospital at the pooled
    rate), FL, SL-AC and SFLv2 (each hospital at its own rate), and with
    ``drop_remainder=False`` on FL: the tiny DenseNet of
    ``tests/test_system.py`` at 16x16, hospitals of 4 and 6 images, batch
    2, so no accountant composes more than 5 steps at one rate (the
    reference adds each step into a float ledger; the port forms count x
    per-step RDP, and the two agree to the bit over so few steps);
  * every ``(method, cut, engine)`` with DP-SGD, cut noise or both that
    the reference builds, the port builds too, and every ``ValueError``
    the reference raises for a private option, the port raises with the
    same message.
"""

import jax
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.core.strategies import make_strategy as j_make_strategy
from repro.data.synthetic import make_cxr_clients
from repro.privacy import PrivacyConfig as JPrivacy
from repro.wire import Transport as JTransport
from repro_torch import optim as TO
from repro_torch.core.strategies import METHODS, make_strategy
from repro_torch.privacy import PrivacyConfig
from repro_torch.wire import Transport
from torch_grid_pair import adapters

torch.set_num_threads(2)

BATCH, LR = 2, 1e-4
DP = dict(noise_multiplier=1.1, clip_norm=1.0)


@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, n_clients=2, train_per_client=[4, 6],
                            val_per_client=2, test_per_client=2,
                            image_size=16)


def _report(pkg, method, clients, **kw):
    split = method not in ("centralized", "fl")
    ja, ta = adapters("tiny", False)
    if pkg == "repro":
        st = j_make_strategy(method, ja, lambda: JO.adam(LR), 2,
                             transport=JTransport("identity") if split
                             else None, engine="stepwise",
                             privacy=JPrivacy(**DP), **kw)
        state = st.setup(jax.random.key(0))
    else:
        st = make_strategy(method, ta, lambda: TO.adam(LR), 2,
                           transport=Transport("identity", device="cpu")
                           if split else None, engine="stepwise",
                           privacy=PrivacyConfig(**DP), device="cpu", **kw)
        state = st.setup(0)
    _, log = st.run_epoch(state, [c.train for c in clients],
                          np.random.default_rng(1), BATCH)
    assert np.isfinite(log.losses).all()
    return st.privacy_report()


@pytest.mark.parametrize("method, kw", [
    ("centralized", {}), ("fl", {}), ("sl_ac", {}), ("sflv2_ac", {}),
    ("fl", dict(drop_remainder=False))],
    ids=["centralized", "fl", "sl_ac", "sflv2_ac", "fl-keep"])
def test_privacy_report_equals_repro(clients, method, kw):
    rj = _report("repro", method, clients, **kw)
    rt = _report("port", method, clients, **kw)
    assert len(rt) == 2 and rt == rj
    assert all(0 < r["epsilon"] < np.inf for r in rt)
    if method == "centralized":             # the pooled rate, 5 steps
        assert rt[0] == rt[1] and rt[0]["steps"] == 5
    else:
        assert rt[0]["epsilon"] != rt[1]["epsilon"]


PRIVACIES = {"dp": dict(noise_multiplier=1.0, clip_norm=1.0),
             "cut": dict(cut_noise_std=0.5),
             "dp+cut": dict(noise_multiplier=1.0, clip_norm=1.0,
                            cut_noise_std=0.5),
             "secagg": dict(secagg=True)}


@pytest.mark.parametrize("engine", ["stepwise", "compiled"])
@pytest.mark.parametrize("nls", [False, True], ids=["LS", "NLS"])
@pytest.mark.parametrize("kind", list(PRIVACIES))
@pytest.mark.parametrize("method", METHODS)
def test_private_options_build_or_raise_as_in_repro(method, kind, nls,
                                                    engine):
    """What the reference builds with a privacy config, the port builds
    (nothing raises ``NotImplementedError`` any more); what it refuses,
    the port refuses with the same ``ValueError``."""
    ja, ta = adapters("tiny", nls)
    split = method not in ("centralized", "fl")
    kw = dict(engine=engine)
    errs = []
    for pkg, mk, ad, cfg, tr in (
            ("repro", j_make_strategy, ja, JPrivacy, lambda: JTransport(
                "int8")),
            ("port", make_strategy, ta, PrivacyConfig, lambda: Transport(
                "int8", device="cpu"))):
        extra = {} if pkg == "repro" else {"device": "cpu"}
        opt = JO.adam if pkg == "repro" else TO.adam
        try:
            st = mk(method, ad, lambda: opt(LR), 3,
                    transport=tr() if split else None,
                    privacy=cfg(**PRIVACIES[kind]), **kw, **extra)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[1] == errs[0]
    if errs[1] is None:
        assert st.privacy.any_enabled and st.engine == engine
