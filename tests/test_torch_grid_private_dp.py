"""DP-SGD on centralized, FL, SL-AC and SFLv2 in the port against
``repro``, on the CPU, LS cut: the tiny DenseNet of
``tests/test_system.py`` at 16x16, 2 hospitals, batch 2, the split family
over an identity link, under ``PrivacyConfig(noise_multiplier=0,
clip_norm=1)`` (the per-example clip, K5/K6's plain versions, and no
random draw, so both packages compute the same thing).  Both start from
the same converted weights and draw the same numpy batches.

  * stepwise, hospitals of 4 and 6 images (2 and 3 steps): losses and
    every param after the epoch within 1e-4 (float32 round-off of
    per-example convolutions and of the clip's sums in another order), as
    ``tests/test_torch_grid_private.py`` holds SFLv1;
  * the weighted estimator: SL-AC on both packages' compiled engines with
    ``drop_remainder=False`` over hospitals of 3 and 5 images (each ends
    in a padded batch of 1), under the same bar;
  * every hospital's accountant counted the same steps.
"""

import numpy as np
import pytest
import torch

from repro.data.synthetic import make_cxr_clients
from repro.privacy import PrivacyConfig as JPrivacy
from repro_torch.privacy import PrivacyConfig
from torch_grid_pair import flat, param_pairs, run_pair

torch.set_num_threads(2)

BATCH, LR, TOL = 2, 1e-4, 1e-4
PRIV = dict(noise_multiplier=0.0, clip_norm=1.0)


def _clients(sizes):
    return make_cxr_clients(seed=0, n_clients=len(sizes),
                            train_per_client=sizes, val_per_client=2,
                            test_per_client=2, image_size=16)


def _assert_pair(method, r):
    lj, lt = r["logs_j"][0], r["logs_t"][0]
    assert lt.steps == lj.steps and lt.weights == lj.weights
    np.testing.assert_allclose(lt.losses, lj.losses, atol=TOL, rtol=0)
    for tj, tt in param_pairs(method, r["states_j"][0], r["states_t"][0]):
        fj, ft = flat(tj), flat(tt)
        assert list(fj) == list(ft)
        for k in fj:
            np.testing.assert_allclose(ft[k], fj[k], atol=TOL, rtol=0,
                                       err_msg=str(k))
    assert [x["steps"] for x in r["st"].privacy_report()] == \
        [x["steps"] for x in r["sj"].privacy_report()]


@pytest.mark.parametrize("method", ["centralized", "fl", "sl_ac",
                                    "sflv2_ac"])
def test_clipped_dp_matches_repro(method):
    codec = None if method in ("centralized", "fl") else "identity"
    r = run_pair(method, False, "tiny", _clients([4, 6]), BATCH, LR, codec,
                 privacy=(JPrivacy(**PRIV), PrivacyConfig(**PRIV)))
    assert r["logs_t"][0].steps == 5
    _assert_pair(method, r)


def test_weighted_estimator_matches_repro_on_padded_batches():
    """Both compiled engines pad each hospital's last batch of 1 to 2 rows
    and weight the DP estimator; the reference's padded rows clip to
    nothing and its mean divides by the real count, as the port's do."""
    r = run_pair("sl_ac", False, "tiny", _clients([3, 5]), BATCH, LR,
                 "identity", engine="compiled", drop_remainder=False,
                 privacy=(JPrivacy(**PRIV), PrivacyConfig(**PRIV)))
    assert r["logs_t"][0].weights == [2, 1, 2, 2, 1]
    _assert_pair("sl_ac", r)
    assert [x["steps"] for x in r["st"].privacy_report()] == [2, 3]
