"""The port's SplitFedv3 slice against ``repro``, end to end, on the CPU:
``sflv3_ac`` on ``DENSENET_MINI`` at 32x32, 5 synthetic hospitals, batch 4,
two stepwise steps over ``Transport("int8")`` fused (K3) and unfused
(K1 then K2), and over an identity link.

Both packages start from the same weights (the reference's ``setup``,
converted by ``repro_torch.interop``) and draw batches from the same numpy
rng stream.  Tolerances:
  * per-hospital losses, validation loss and evaluation scores: <= 1e-4
    (float32 round-off of convolutions summed in another order; a
    cut-tensor element that lies within that round-off of a half level may
    land on the neighbouring int8 level, which moves a loss by far less
    than 1e-4);
  * params after the steps over the int8 link: <= 1e-4 for 99.9% of the
    elements, the Adam update within 1% of lr for 95% of them and for half
    of every leaf's, the rest left free for the reason
    ``test_params_after_steps_match_repro`` gives; over an identity link,
    every param <= 1e-5;
  * wire bytes, the epoch's schedule signature, ``comm_per_epoch`` and the
    hospitals' arrays: exactly equal.
"""

import jax
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.configs.paper_models import DENSENET_MINI as J_MINI
from repro.core.comm import comm_per_epoch as j_comm_per_epoch
from repro.core.partition import cnn_adapter as j_cnn_adapter
from repro.core.strategies import make_strategy as j_make_strategy
from repro.data.synthetic import make_cxr_clients as j_make_cxr_clients
from repro.models.cnn import build_densenet as j_build
from repro.wire import Transport as JTransport
from repro_torch import optim as TO
from repro_torch.configs.paper_models import DENSENET_MINI
from repro_torch.core.comm import comm_per_epoch
from repro_torch.core.partition import cnn_adapter
from repro_torch.core.strategies import make_strategy
from repro_torch.data.synthetic import make_cxr_clients
from repro_torch.interop import params_to_numpy, sflv3_state_from_jax
from repro_torch.models.cnn import build_densenet
from repro_torch.wire import Transport

torch.set_num_threads(2)

# the paper's Adam step size (§3.2)
N_CLIENTS, BATCH, LR, TOL = 5, 4, 1e-4, 1e-4
DATA = dict(seed=0, n_clients=N_CLIENTS, train_per_client=2 * BATCH,
            val_per_client=6, test_per_client=6, image_size=32)


def _flat(tree, path=()):
    """{path: leaf}, dict keys sorted (jax.tree's order)."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _flat(tree[k], path + (k,)).items()}
    return {path: tree}


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module")
def clients():
    return j_make_cxr_clients(**DATA)


def _ref_epoch(clients, codec):
    """One epoch (two steps) of the reference over ``codec``, fused (for
    int8 the reference holds it bit-equal to its unfused link)."""
    ja = j_cnn_adapter(j_build(J_MINI))
    tj = JTransport(codec, fuse=True)
    sj = j_make_strategy("sflv3_ac", ja, lambda: JO.adam(LR), N_CLIENTS,
                         transport=tj, engine="stepwise")
    state_j = sj.setup(jax.random.key(0))
    start = jax.tree.map(np.asarray, state_j)
    state_j, log_j = sj.run_epoch(state_j, [c.train for c in clients],
                                  np.random.default_rng(1), BATCH)
    return dict(start=start, sj=sj, state_j=state_j, log_j=log_j, tj=tj,
                ja=ja)


def _port_epoch(ref, clients, codec, fuse):
    """The same epoch in the port, from the reference's start."""
    ta = cnn_adapter(build_densenet(DENSENET_MINI))
    tt = Transport(codec, fuse=fuse, device="cpu")
    st = make_strategy("sflv3_ac", ta, lambda: TO.adam(LR), N_CLIENTS,
                       transport=tt, engine="stepwise", device="cpu")
    state_t = sflv3_state_from_jax(ref["start"], "cpu")
    state_t, log_t = st.run_epoch(state_t, [c.train for c in clients],
                                  np.random.default_rng(1), BATCH)
    return dict(ref, st=st, state_t=state_t, log_t=log_t, tt=tt, ta=ta)


@pytest.fixture(scope="module")
def ref(clients):
    return _ref_epoch(clients, "int8")


@pytest.fixture(scope="module", params=[True, False], ids=["fused",
                                                            "unfused"])
def runs(request, ref, clients):
    """The port's epoch over K3 (fused) or K1 then K2 (unfused)."""
    return _port_epoch(ref, clients, "int8", request.param)


def test_hospitals_are_byte_identical(clients):
    mine = make_cxr_clients(**DATA)
    assert [c.name for c in mine] == [c.name for c in clients]
    for a, b in zip(mine, clients):
        for split in ("train", "val", "test"):
            da, db = getattr(a, split), getattr(b, split)
            assert list(da) == list(db)
            for k in da:
                assert da[k].dtype == db[k].dtype
                assert da[k].tobytes() == db[k].tobytes()


def test_step_losses_match_repro(runs):
    lj, lt = runs["log_j"], runs["log_t"]
    assert lt.steps == lj.steps == 2
    assert lt.client_steps == lj.client_steps
    assert len(lt.losses) == len(lj.losses) == 2 * N_CLIENTS
    assert np.isfinite(lt.losses).all()
    _close(lj.losses, lt.losses)


def _leaves(run):
    """(reference, port, start) flat param dicts of every hospital's client
    segment and of the server."""
    start = run["start"]
    sj, st = run["state_j"], run["state_t"]
    stacked = jax.tree.map(np.asarray, sj["stacked_clients"])
    trees = [(_flat(jax.tree.map(lambda a: a[i], stacked)),
              _flat(params_to_numpy(ct)),
              _flat(jax.tree.map(lambda a: a[i], start["stacked_clients"])))
             for i, ct in enumerate(st["clients"])]
    trees.append((_flat(jax.tree.map(np.asarray, sj["server"])),
                  _flat(params_to_numpy(st["server"])),
                  _flat(start["server"])))
    for fj, ft, f0 in trees:
        assert list(fj) == list(ft) == list(f0)
    return trees


def test_params_after_steps_match_repro(runs):
    """Over the int8 link: overall, at least 99.9% of the params within
    1e-4 and 95% of the Adam updates within 1% of lr; in every leaf, at
    least half of the updates within 1% of lr.

    Not all of them: a cut-tensor element within round-off of a half level
    lands on the neighbouring int8 level in one package, and the server's
    first layers then see another input.  Adam divides each gradient by
    its own magnitude, so where that moves a small gradient the update
    moves by up to lr each step; in a hospital's front up to 30% of a
    leaf's updates part this way.  A wrong update of a leaf (a sign, a
    scale, a GroupNorm param or the head's bias) moves nearly all of that
    leaf's elements.  ``test_params_over_identity_link_match_repro`` holds
    the same step without quantisation to 1e-5 in every leaf.
    """
    n_all = n_far = n_same = 0
    for fj, ft, f0 in _leaves(runs):
        for k in fj:
            same = np.abs((fj[k] - f0[k]) - (ft[k] - f0[k])) <= 0.01 * LR
            assert same.mean() >= 0.5, (k, same.mean())
            n_same += int(same.sum())
            n_far += int((np.abs(fj[k] - ft[k]) > TOL).sum())
            n_all += same.size
    assert n_far <= 0.001 * n_all
    assert n_same >= 0.95 * n_all
    sj, st = runs["state_j"], runs["state_t"]
    assert st["s_opt"]["step"] == int(sj["s_opt"]["step"]) == 2


def test_params_over_identity_link_match_repro(clients):
    """Over an identity link nothing is quantised and nothing flips: after
    two steps every param of every leaf agrees within 1e-5, and in every
    leaf at least 99.9% of the Adam updates within 1% of lr (float32
    round-off of convolutions summed in another order moves the rest)."""
    run = _port_epoch(_ref_epoch(clients, "identity"), clients, "identity",
                      True)
    _close(run["log_j"].losses, run["log_t"].losses)
    for fj, ft, f0 in _leaves(run):
        for k in fj:
            np.testing.assert_allclose(ft[k], fj[k], atol=1e-5, rtol=0,
                                       err_msg=str(k))
            same = np.abs((fj[k] - f0[k]) - (ft[k] - f0[k])) <= 0.01 * LR
            assert same.mean() >= 0.999, (k, same.mean())


def test_wire_bytes_equal_repro(runs):
    tj, tt = runs["tj"], runs["tt"]
    assert tt.steps == tj.steps == 2 * N_CLIENTS
    assert tt.bytes_on_wire == tj.bytes_on_wire > 0
    assert tt.bytes_raw == tj.bytes_raw
    assert tt.summary() == tj.summary()
    assert len(tt.epoch_log) == len(tj.epoch_log) == 1
    ej, et = tj.epoch_log[0], tt.epoch_log[0]
    assert (et.kind, et.schedule, et.tr_counts, et.legs) == \
        (ej.kind, ej.schedule, ej.tr_counts, ej.legs)
    assert not ej.nls


@pytest.mark.parametrize("method", ["sflv3_ac", "sflv1_ac", "sl_am", "fl",
                                    "centralized"])
@pytest.mark.parametrize("codec", [None, "int8"])
def test_comm_per_epoch_equals_repro(runs, clients, codec, method):
    from repro.wire import make_codec as j_make_codec
    from repro_torch.wire import make_codec
    example = {k: v[:BATCH] for k, v in clients[0].train.items()}
    n_tr = [len(c.train["label"]) for c in clients]
    n_va = [len(c.val["label"]) for c in clients]
    pj = j_comm_per_epoch(method, runs["ja"], example, n_tr, n_va, BATCH,
                          codec=codec and j_make_codec(codec))
    pt = comm_per_epoch(method, runs["ta"], example, n_tr, n_va, BATCH,
                        codec=codec and make_codec(codec))
    assert pt.bytes_per_epoch == pj.bytes_per_epoch
    assert pt.breakdown == pj.breakdown


def test_val_loss_and_evaluate_match_repro(runs, clients):
    sj, st = runs["sj"], runs["st"]
    _close(sj.val_loss(runs["state_j"], clients),
           st.val_loss(runs["state_t"], clients))
    datas = [c.test for c in clients]
    for a, b in zip(sj.scores_all(runs["state_j"], datas),
                    st.scores_all(runs["state_t"], datas)):
        assert a.shape == b.shape
        _close(a, b)
    mj = sj.evaluate(runs["state_j"], clients)
    mt = st.evaluate(runs["state_t"], clients)
    assert list(mt) == list(mj)
    assert all(np.isfinite(v) for v in mt.values())


def test_port_setup_has_the_reference_layout(runs):
    mine = runs["st"].setup(0)
    conv = runs["state_t"]
    assert len(mine["clients"]) == len(conv["clients"]) == N_CLIENTS
    for a, b in [(mine["clients"][0], conv["clients"][0]),
                 (mine["server"], conv["server"])]:
        fa, fb = _flat(a), _flat(b)
        assert list(fa) == list(fb)
        assert all(fa[k].shape == fb[k].shape and fa[k].dtype == fb[k].dtype
                   for k in fa)
    assert mine["s_opt"]["step"] == 0 and len(mine["c_opts"]) == N_CLIENTS


# precision="bf16" (M4), engine="compiled" (M6), privacy on the whole grid
# (M8), participation and the aggregation rules (M9), observe= (M10) and
# shard= (M11) are ported now: their cases keep their ids and check what
# holds on those paths (an option that builds, expect None; or the
# reference's ValueError, a message; shard= with participation= is one)
@pytest.mark.parametrize("kw, expect", [
    pytest.param(dict(precision="bf16", method="fl",
                      aggregator="trimmed_mean"), None, id="kw0-M4"),
    pytest.param(dict(observe=True), None, id="kw1-M10"),
    pytest.param(dict(shard=True, participation=dict(k=2)),
                 "shard= is not supported", id="kw2-M11"),
    pytest.param(dict(participation=dict(q=0.5)),
                 "fixed-size participation only", id="kw3-M9"),
    pytest.param(dict(engine="compiled", method="sflv2_ac",
                      privacy=dict(cut_noise_std=0.5),
                      participation=dict(k=2)), None, id="kw4-M6"),
    pytest.param(dict(method="fl", privacy=dict(noise_multiplier=1.0,
                                                clip_norm=1.0),
                      aggregator="coordinate_median"), None, id="kw5-M8"),
    pytest.param(dict(method="sl_ac", nls=True,
                      privacy=dict(noise_multiplier=1.0, clip_norm=1.0),
                      observe=True), None, id="kw6-M8"),
])
def test_unported_options_raise_naming_their_roadmap_item(kw, expect):
    from repro_torch.core.participation import Participation
    from repro_torch.privacy import PrivacyConfig
    ta = cnn_adapter(build_densenet(DENSENET_MINI, nls=kw.pop("nls", False)))
    method = kw.pop("method", "sflv3_ac")
    if "privacy" in kw:
        kw["privacy"] = PrivacyConfig(**kw["privacy"])
    if "participation" in kw:
        kw["participation"] = Participation(n_global=N_CLIENTS,
                                            **kw["participation"])

    def build():
        return make_strategy(method, ta, lambda: TO.adam(LR), N_CLIENTS,
                             device="cpu", **kw)
    if expect is None:
        st = build()
        assert st.participation is kw.get("participation")
        assert (st.observe is not None) == ("observe" in kw)
        if "aggregator" in kw:
            assert st._agg.name == kw["aggregator"]
    else:
        with pytest.raises(ValueError, match=expect):
            build()


def test_make_strategy_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ta = cnn_adapter(build_densenet(DENSENET_MINI))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_strategy("sflv3_ac", ta, lambda: TO.adam(LR), N_CLIENTS)
    st = make_strategy("sflv3_ac", ta, lambda: TO.adam(LR), N_CLIENTS,
                       transport=Transport("int8", device="cpu"),
                       device="cpu")
    assert st.device == torch.device("cpu")
