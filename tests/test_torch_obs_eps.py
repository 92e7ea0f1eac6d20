"""The per-round epsilon series of observed private runs in the port
against ``repro``, on the CPU: FL (the client-major reduction) and SL-AM
(the scheduled one) under ``PrivacyConfig(
noise_multiplier=1.1, clip_norm=1)``, the tiny DenseNet at 16x16, 3
hospitals of 8, 10 and 11 images (2 steps a round each at batch 4, three
sampling rates), 2 rounds, compiled engines (``tests/torch_obs_pair.py``).

Every round's epsilon row equals the reference's, with at most 5 steps per
sampling rate (the reference adds each call into a float ledger, the port
forms count x per-step RDP; over so few steps they agree to the bit); the
last row equals the port's own ``privacy_report`` and the rows increase.
The companion file ``tests/test_torch_obs_eps_part.py`` holds SFLv3 and
participating FL; most of each file's time is the reference's JAX compile
of its noised per-example DP step.
"""

import pytest
import torch

from repro.data.synthetic import make_cxr_clients
from torch_obs_pair import DP, assert_epsilon_series, observed_pair

torch.set_num_threads(2)

ROWS = {"fl": DP, "sl_am": DP}


@pytest.fixture(scope="module")
def small():
    return make_cxr_clients(seed=0, train_per_client=[8, 10, 11],
                            val_per_client=2, test_per_client=2,
                            image_size=16, n_clients=3)


@pytest.mark.parametrize("method", list(ROWS))
def test_epsilon_series_matches_the_reference(small, method):
    assert_epsilon_series(*observed_pair(small, method, ROWS[method]))
