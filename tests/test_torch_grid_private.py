"""Private SFLv1 (``sflv1_ac``, LS cut) in the port against ``repro``, on
the CPU, stepwise: SFLv3's private step (DP-SGD, K5/K6's plain versions)
and then the unweighted mean of the client segments.  The tiny DenseNet
of ``tests/test_system.py`` at 32x32, 2 hospitals, batch 2, two steps over
an identity link, under ``PrivacyConfig(noise_multiplier=0, clip_norm=1)``
(the per-example clip and no random draw, so both packages compute the
same thing).  Both start from the same converted weights and draw the
same numpy batches; losses and every param after the epoch within 1e-4
(float32 round-off of per-example convolutions and of the clip's sums in
another order), and both hospitals hold the same client tree.
"""

import numpy as np
import torch

from repro.data.synthetic import make_cxr_clients
from repro.privacy import PrivacyConfig as JPrivacy
from repro_torch.privacy import PrivacyConfig
from torch_grid_pair import client_trees, flat, param_pairs, run_pair

torch.set_num_threads(2)

BATCH, LR, TOL = 2, 1e-4, 1e-4
PRIV = dict(noise_multiplier=0.0, clip_norm=1.0)


def test_private_sflv1_matches_repro():
    clients = make_cxr_clients(seed=0, n_clients=2,
                               train_per_client=2 * BATCH, val_per_client=2,
                               test_per_client=2, image_size=32)
    r = run_pair("sflv1_ac", False, "tiny", clients, BATCH, LR, "identity",
                 privacy=(JPrivacy(**PRIV), PrivacyConfig(**PRIV)))
    lj, lt = r["logs_j"][0], r["logs_t"][0]
    assert lt.steps == lj.steps == 2
    np.testing.assert_allclose(lt.losses, lj.losses, atol=TOL, rtol=0)
    for tj, tt in param_pairs("sflv1_ac", r["states_j"][0],
                              r["states_t"][0]):
        fj, ft = flat(tj), flat(tt)
        assert list(fj) == list(ft)
        for k in fj:
            np.testing.assert_allclose(ft[k], fj[k], atol=TOL, rtol=0,
                                       err_msg=str(k))
    a, b = (flat(t) for t in client_trees(r["states_t"][0]))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert [x["steps"] for x in r["st"].privacy_report()] == \
        [x["steps"] for x in r["sj"].privacy_report()] == [2, 2]
