"""The port's private SplitFedv3 step against ``repro``'s, on the CPU:
``sflv3_ac`` at 32x32, 2 hospitals, batch 2, two stepwise steps under
``PrivacyConfig(noise_multiplier=0, clip_norm=1.0)`` (DP-SGD with its
per-example clip, K5/K6, and no random draw, so both packages compute the
same thing).  The identity link runs ``DENSENET_MINI``; the int8 link runs
the reference's own tiny privacy model (``tests/test_privacy.py``), since
the reference's compile of its per-example step takes most of this file's
time and the tiny model's takes a fifth of the mini one's.

Both start from the reference's ``setup`` (converted by
``repro_torch.interop``) and draw batches from the same numpy rng stream.
Tolerances:
  * over an identity link: both steps' losses and every param within 1e-4
    (float32 round-off of per-example convolutions and of the clip's sums
    in another order);
  * over the int8 link (fused, K3): the first step's losses within 1e-4;
    later steps are not held, for the reason ``test_torch_sflv3.py`` gives
    (a cut-tensor element within round-off of a half level may land on
    the neighbouring level, and Adam turns that into another update).
"""

import jax
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.configs.paper_models import DENSENET_MINI as J_MINI
from repro.core.partition import cnn_adapter as j_cnn_adapter
from repro.core.strategies import make_strategy as j_make_strategy
from repro.data.synthetic import make_cxr_clients
from repro.models.cnn import DenseNetConfig as JConfig
from repro.models.cnn import build_densenet as j_build
from repro.privacy import PrivacyConfig as JPrivacy
from repro.wire import Transport as JTransport
from repro_torch import optim as TO
from repro_torch.configs.paper_models import DENSENET_MINI
from repro_torch.core.partition import cnn_adapter
from repro_torch.core.strategies import make_strategy
from repro_torch.interop import params_to_numpy, sflv3_state_from_jax
from repro_torch.models.cnn import DenseNetConfig, build_densenet
from repro_torch.privacy import PrivacyConfig
from repro_torch.wire import Transport

torch.set_num_threads(2)

N_CLIENTS, BATCH, LR, TOL = 2, 2, 1e-4, 1e-4
PRIV = dict(noise_multiplier=0.0, clip_norm=1.0)
TINY = dict(growth=4, blocks=(1, 1), stem_ch=8, cut_layer=1)


@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, n_clients=N_CLIENTS,
                            train_per_client=2 * BATCH, val_per_client=2,
                            test_per_client=2, image_size=32)


def _epochs(clients, codec, j_cfg, t_cfg):
    """One epoch (two steps) of both packages from the same start."""
    sj = j_make_strategy("sflv3_ac", j_cnn_adapter(j_build(j_cfg)),
                         lambda: JO.adam(LR), N_CLIENTS,
                         transport=JTransport(codec), engine="stepwise",
                         privacy=JPrivacy(**PRIV))
    state_j = sj.setup(jax.random.key(0))
    start = jax.tree.map(np.asarray, state_j)
    state_j, log_j = sj.run_epoch(state_j, [c.train for c in clients],
                                  np.random.default_rng(1), BATCH)
    st = make_strategy("sflv3_ac", cnn_adapter(build_densenet(t_cfg)),
                       lambda: TO.adam(LR), N_CLIENTS,
                       transport=Transport(codec, device="cpu"),
                       privacy=PrivacyConfig(**PRIV), device="cpu")
    state_t, log_t = st.run_epoch(sflv3_state_from_jax(start, "cpu"),
                                  [c.train for c in clients],
                                  np.random.default_rng(1), BATCH)
    return sj, state_j, log_j, st, state_t, log_t


def test_private_steps_match_repro_over_identity_link(clients):
    sj, state_j, log_j, st, state_t, log_t = _epochs(clients, "identity",
                                                    J_MINI, DENSENET_MINI)
    assert log_t.steps == log_j.steps == 2
    assert np.isfinite(log_t.losses).all()
    np.testing.assert_allclose(log_t.losses, log_j.losses, atol=TOL, rtol=0)
    stacked = jax.tree.map(np.asarray, state_j["stacked_clients"])
    pairs = [(jax.tree.map(lambda a: a[i], stacked),
              params_to_numpy(state_t["clients"][i]))
             for i in range(N_CLIENTS)]
    pairs.append((jax.tree.map(np.asarray, state_j["server"]),
                  params_to_numpy(state_t["server"])))
    for tj, tt in pairs:
        lj, lt = jax.tree.leaves(tj), jax.tree.leaves(tt)
        assert len(lj) == len(lt)
        for a, b in zip(lj, lt):
            np.testing.assert_allclose(b, a, atol=TOL, rtol=0)
    # every hospital accounted each step (epsilon is inf at noise 0)
    assert [r["steps"] for r in st.privacy_report()] == \
        [r["steps"] for r in sj.privacy_report()] == [2] * N_CLIENTS


def test_private_first_step_matches_repro_over_int8_link(clients):
    _, _, log_j, _, _, log_t = _epochs(clients, "int8", JConfig(**TINY),
                                       DenseNetConfig(**TINY))
    first = slice(0, N_CLIENTS)
    np.testing.assert_allclose(log_t.losses[first], log_j.losses[first],
                               atol=TOL, rtol=0)
    assert np.isfinite(log_t.losses).all()
