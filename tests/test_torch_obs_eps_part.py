"""The per-round epsilon series of observed private runs in the port
against ``repro``, on the CPU (``tests/test_torch_obs_eps.py``'s setup:
the tiny DenseNet at 16x16, 3 hospitals of 8, 10 and 11 images, batch 4, 2
rounds, ``PrivacyConfig(noise_multiplier=1.1, clip_norm=1)``): SFLv3 with
cut-layer noise (std 0.5; the synchronous reduction) and FL under
fixed-size participation, 2 of the 3 hospitals a round (every hospital
composes every round at the amplified rate over its would-be step count):
every epsilon row equal to the reference's, the last to the port's
``privacy_report``, and each round's ``participation`` the reference's
sampled ids.
"""

import pytest
import torch

from repro.data.synthetic import make_cxr_clients
from torch_obs_pair import DP, assert_epsilon_series, observed_pair

torch.set_num_threads(2)

ROWS = {"sflv3_ac": (dict(DP, cut_noise_std=0.5), None),
        "fl-k2of3": (DP, dict(n_global=3, k=2, seed=0))}


@pytest.fixture(scope="module")
def small():
    return make_cxr_clients(seed=0, train_per_client=[8, 10, 11],
                            val_per_client=2, test_per_client=2,
                            image_size=16, n_clients=3)


@pytest.mark.parametrize("row", list(ROWS))
def test_epsilon_series_matches_the_reference(small, row):
    privacy, part = ROWS[row]
    sj, st = observed_pair(small, row.split("-")[0], privacy, part)
    assert_epsilon_series(sj, st, part)
