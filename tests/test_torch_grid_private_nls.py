"""Cut-layer noise at every crossing, and DP-SGD in the NLS (U-shaped)
cut, in the port against ``repro``, on the CPU: the tiny DenseNet of
``tests/test_system.py`` at 16x16, batch 2.

The port draws its noise from ``torch.Generator`` streams, not threefry,
so the draws are injected into both packages (each one's ``_leaf_noise``
monkeypatched), as ``tests/test_torch_privacy.py`` does.  Tolerances:
  * both crossings (front->middle and middle->tail) of one SL step, on an
    identity link and on the int8 link fused (K4) and unfused (K1, K2 +
    the add), with the reference's own boundary hook on the same input and
    draws: bit-equal, and with pad-and-mask weights 0/1 too;
  * SL-AC one epoch (2 hospitals of 4 images) in the LS and NLS cuts with
    cut noise over an identity link, each package's draws a function of
    the leaf's shape: losses within 1e-4 and every param within 1e-6, the
    bars ``tests/test_torch_grid.py`` holds the rows without noise to;
  * SL-AC and SFLv3 in the NLS cut under ``PrivacyConfig(noise_multiplier
    =0, clip_norm=1)`` (the clip, no draw): losses and every param within
    1e-4, as ``tests/test_torch_grid_private.py`` holds SFLv1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_cxr_clients
from repro.privacy import PrivacyConfig as JPrivacy
from repro.privacy import dpsgd as JD
from repro.wire import Transport as JTransport
from repro_torch import optim as TO
from repro_torch.core.strategies import make_strategy
from repro_torch.interop import params_from_jax
from repro_torch.privacy import PrivacyConfig
from repro_torch.privacy import dpsgd as TD
from repro_torch.tree import tree_leaves
from repro_torch.wire import Transport
from torch_grid_pair import adapters, flat, param_pairs, run_pair

torch.set_num_threads(2)

BATCH, LR, TOL = 2, 1e-4, 1e-4
PARAM_TOL = 0.01 * LR
STD = 0.5
CLIP = dict(noise_multiplier=0.0, clip_norm=1.0)
LINKS = {"identity": ("identity", True), "int8-fused": ("int8", True),
         "int8-unfused": ("int8", False)}


@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, n_clients=2, train_per_client=2 * BATCH,
                            val_per_client=2, test_per_client=2,
                            image_size=16)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weights01"])
@pytest.mark.parametrize("link", list(LINKS))
def test_both_crossings_bit_equal_to_repro(monkeypatch, clients, link,
                                           weighted):
    """One SL step's crossings in the NLS cut: the port's hook (the draws
    of ``Strategy._draws``, one list entry per crossing) against the
    reference's ``boundary_with_key`` (its crossing counter) fed the same
    draws, on the same front and middle outputs."""
    ja, ta = adapters("tiny", True)
    codec, fuse = LINKS[link]
    pj = ja.init(jax.random.key(0))
    pt = params_from_jax(jax.tree.map(np.asarray, pj))
    batch = {k: v[:BATCH] for k, v in clients[0].train.items()}
    tt = Transport(codec, fuse=fuse, device="cpu")
    tj = JTransport(codec, fuse=fuse)
    st = make_strategy("sl_ac", ta, lambda: TO.adam(LR), 2, transport=tt,
                       privacy=PrivacyConfig(cut_noise_std=STD),
                       engine="stepwise", device="cpu")
    draws = st._draws(3, 1, batch, BATCH, None)["cut"]
    assert len(draws) == 2
    queue = [l.numpy() for l in tree_leaves(draws)]
    monkeypatch.setattr(JD, "_leaf_noise",
                        lambda l, lk, s: jnp.asarray(queue.pop(0)))
    w = np.asarray([1.0, 0.0], np.float32) if weighted else None
    hook_t = TD.crossings(tt.boundary,
                          TD.cut_noise_boundary(tt.boundary, tt.fused_codec),
                          draws, None if w is None else torch.from_numpy(w))
    hook_j = JD.boundary_with_key(tj.boundary, JPrivacy(cut_noise_std=STD),
                                  jax.random.key(5),
                                  None if w is None else jnp.asarray(w),
                                  codec=tj.fused_codec)
    x = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        h = ta.apply_seg("front", pt["front"], ta.inputs(x), x, True)
        for i, seg in enumerate(("middle", None)):
            out_t = hook_t(h)
            out_j = hook_j(jnp.asarray(h.numpy()))
            np.testing.assert_array_equal(_f32(out_j), _f32(out_t),
                                          err_msg=f"crossing {i}")
            if w is not None:       # the padded row ships clean
                np.testing.assert_array_equal(
                    _f32(out_t)[1], _f32(tt.boundary(h))[1])
            if seg:
                h = ta.apply_seg(seg, pt[seg], out_t, x, True)
    assert not queue


def _shape_noise(shape) -> np.ndarray:
    """Pre-scaled draws that depend on the leaf's shape alone (each
    crossing has its own shape), so both packages get the same draws
    whichever key or generator they hold."""
    seed = int(np.prod(shape)) * 31 + len(shape)
    return (STD * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


@pytest.mark.parametrize("nls", [False, True], ids=["LS", "NLS"])
def test_cut_noise_training_matches_repro(monkeypatch, clients, nls):
    monkeypatch.setattr(JD, "_leaf_noise", lambda l, lk, s: jnp.asarray(
        _shape_noise(tuple(l.shape))))
    monkeypatch.setattr(TD, "_leaf_noise", lambda l, gen, s: torch.from_numpy(
        _shape_noise(tuple(l.shape))))
    priv = (JPrivacy(cut_noise_std=STD), PrivacyConfig(cut_noise_std=STD))
    r = run_pair("sl_ac", nls, "tiny", clients, BATCH, LR, "identity",
                 privacy=priv)
    lj, lt = r["logs_j"][0], r["logs_t"][0]
    assert lt.steps == lj.steps == 4
    np.testing.assert_allclose(lt.losses, lj.losses, atol=TOL, rtol=0)
    for tj, tt in param_pairs("sl_ac", r["states_j"][0], r["states_t"][0]):
        fj, ft = flat(tj), flat(tt)
        assert list(fj) == list(ft)
        for k in fj:
            np.testing.assert_allclose(ft[k], fj[k], atol=PARAM_TOL, rtol=0,
                                       err_msg=str(k))
    # the noise really moved the run: without it the losses differ
    plain = run_pair("sl_ac", nls, "tiny", clients, BATCH, LR, "identity")
    assert not np.allclose(plain["logs_t"][0].losses, lt.losses, atol=1e-3)


@pytest.mark.parametrize("method", ["sl_ac", "sflv3_ac"])
def test_clipped_dp_in_the_nls_cut_matches_repro(clients, method):
    r = run_pair(method, True, "tiny", clients, BATCH, LR, "identity",
                 privacy=(JPrivacy(**CLIP), PrivacyConfig(**CLIP)))
    lj, lt = r["logs_j"][0], r["logs_t"][0]
    assert lt.steps == lj.steps
    np.testing.assert_allclose(lt.losses, lj.losses, atol=TOL, rtol=0)
    for tj, tt in param_pairs(method, r["states_j"][0], r["states_t"][0]):
        fj, ft = flat(tj), flat(tt)
        assert list(fj) == list(ft)
        for k in fj:
            np.testing.assert_allclose(ft[k], fj[k], atol=TOL, rtol=0,
                                       err_msg=str(k))
    assert [x["steps"] for x in r["st"].privacy_report()] == \
        [x["steps"] for x in r["sj"].privacy_report()]


def test_nls_draws_cover_both_crossings_at_the_padded_length(clients):
    """``Strategy._draws`` draws each crossing at the padded batch length
    from the hospital's cut stream, and a short batch takes the first
    rows of the same draws."""
    _, ta = adapters("tiny", True)
    st = make_strategy("sl_am", ta, lambda: TO.adam(LR), 2,
                       privacy=PrivacyConfig(cut_noise_std=STD),
                       engine="stepwise", device="cpu")
    full = {k: v[:4] for k, v in clients[0].train.items()}
    short = {k: v[:1] for k, v in clients[0].train.items()}
    a = st._draws(7, 0, full, 4, None)["cut"]
    b = st._draws(7, 0, short, 4, None)["cut"]
    specs = list(ta.boundary_specs(full).values())
    assert [tuple(l.shape) for l in tree_leaves(a)] == \
        [tuple(l.shape) for l in tree_leaves(specs)]
    assert all(torch.equal(x[:1], y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))
    other = st._draws(7, 1, full, 4, None)["cut"]
    assert not any(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(other)))
