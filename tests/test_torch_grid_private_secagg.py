"""Secure aggregation (``privacy.secagg``, ``core.aggregate.SecAggregator``)
and the leakage probes (``privacy.leakage``) in the port against
``repro``, on the CPU.  Tolerances:
  * ``SecAgg``: every masked upload, the aggregate and ``summary()``
    bit-equal to the reference's on the same trees (dict keys in any
    insertion order: both draw the masks in sorted-key order);
  * FL with ``secagg=True`` (the tiny DenseNet of ``tests/test_system.py``
    at 16x16, 2 hospitals of 4 images, batch 2, one round): every masked
    upload and the aggregate are bit-equal to the reference's ``SecAgg``
    applied to the port's own locals, and the global params are within
    1e-6 of the reference's (they read 0 here: the 2^-16 fixed point
    absorbs the locals' float32 round-off, 3e-8 without secagg; an
    element within that round-off of a rounding boundary would land one
    quantum away);
  * FL with ``secagg=True`` on the compiled engine (host-side rounds after
    the replays) against the stepwise one: params within 1e-5 (the
    engines' bar, ``tests/test_torch_engine.py``) and the same metered
    bytes and rounds;
  * ``measure_leakage`` and its probes on the same activations: within
    1e-6 of the reference's; the port's ``smashed_activations`` within
    1e-5 of the reference's on the same converted params.
"""

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_cxr_clients
from repro.privacy import PrivacyConfig as JPrivacy
from repro.privacy import leakage as JL
from repro.privacy import secagg as JS
from repro.wire import Transport as JTransport
from repro_torch import optim as TO
from repro_torch.core import aggregate as AGG
from repro_torch.core.strategies import make_strategy
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.privacy import PrivacyConfig
from repro_torch.privacy import leakage as TL
from repro_torch.privacy.secagg import SecAgg
from repro_torch.wire import Transport
from torch_grid_pair import adapters, flat, run_pair

torch.set_num_threads(2)

BATCH, LR = 2, 1e-4
QUANTUM = 2.0 ** -16


def _trees(n, seed=0):
    rng = np.random.default_rng(seed)
    # insertion order differs from the sorted order on purpose
    return [{"w": rng.standard_normal((3, 5)).astype(np.float32) * 4,
             "b": {"z": rng.standard_normal((7,)).astype(np.float32),
                   "a": rng.standard_normal((2, 2, 3)).astype(np.float32)}}
            for _ in range(n)]


def _equal(a, b):
    fa, fb = flat(a), flat(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=str(k))


@pytest.mark.parametrize("n", [2, 3, 5])
def test_secagg_bit_equal_to_repro(n):
    trees, weights = _trees(n), [40.0, 17.0, 3.0, 25.0, 9.0][:n]
    sj, st = JS.SecAgg(n, seed=7), SecAgg(n, seed=7)
    for c in range(n):
        _equal(sj.mask_update(c, trees[c], 0.3), st.mask_update(c, trees[c],
                                                                0.3))
    for _ in range(2):                       # the round counter keys masks
        _equal(sj.aggregate_weighted(trees, weights),
               st.aggregate_weighted(trees, weights))
    assert st.summary() == sj.summary()
    # masks cancel: the aggregate is the weighted mean within a quantum
    agg = st.aggregate_weighted(trees, weights)
    mean = {k: sum(w * t[k] for w, t in zip(weights, trees)) / sum(weights)
            for k in ("w",)}
    assert np.abs(agg["w"] - mean["w"]).max() <= n * QUANTUM


def test_secaggregator_keeps_prev_without_weight():
    prev = {"w": torch.ones(3)}
    agg = AGG.SecAggregator(SecAgg(2))
    assert agg.aggregate_trees([{"w": torch.zeros(3)}] * 2, [0, 0],
                               prev=prev) is prev


def test_secaggregator_keeps_the_locals_layout_and_key_order():
    """The round comes back as the port's trees: OIHW conv weights, the
    locals' key order (other code walks leaves by position), their dtype;
    and it is the weighted mean within a quantum per hospital."""
    rng = np.random.default_rng(1)
    trees = [{"z": {"w": torch.from_numpy(rng.standard_normal(
        (4, 3, 2, 2)).astype(np.float32))},
              "a": torch.from_numpy(rng.standard_normal(5).astype(
                  np.float32))} for _ in range(3)]
    out = AGG.SecAggregator(SecAgg(3)).aggregate_trees(trees, [1, 2, 3])
    assert list(out) == ["z", "a"]
    assert out["z"]["w"].shape == (4, 3, 2, 2)
    assert out["a"].dtype == torch.float32
    mean = sum(w * t["z"]["w"] for w, t in zip([1, 2, 3], trees)) / 6
    assert float((out["z"]["w"] - mean).abs().max()) <= 3 * QUANTUM


@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, n_clients=2, train_per_client=2 * BATCH,
                            val_per_client=2, test_per_client=16,
                            image_size=16)


def test_fl_secagg_matches_repro(monkeypatch, clients):
    """The round's masked uploads and aggregate are the reference
    protocol's on the port's own locals (in the reference's layout)."""
    seen = {"locals": [], "uploads": []}
    real_agg, real_mask = SecAgg.aggregate_weighted, SecAgg.mask_update

    def spy_agg(self, trees, weights):
        seen["locals"].append((trees, list(weights)))
        return real_agg(self, trees, weights)

    def spy_mask(self, client, tree, weight):
        out = real_mask(self, client, tree, weight)
        seen["uploads"].append(out)
        return out
    monkeypatch.setattr(SecAgg, "aggregate_weighted", spy_agg)
    monkeypatch.setattr(SecAgg, "mask_update", spy_mask)
    priv = (JPrivacy(secagg=True), PrivacyConfig(secagg=True))
    r = run_pair("fl", False, "tiny", clients, BATCH, LR, privacy=priv)
    assert r["st"].secagg.summary() == r["sj"].secagg.summary()
    (trees, weights), = seen["locals"]
    assert weights == [4.0, 4.0]
    ref = JS.SecAgg(2, seed=0)
    for c, up in enumerate(seen["uploads"]):
        _equal(ref.mask_update(c, trees[c], weights[c] / sum(weights)), up)
    _equal(ref.aggregate_weighted(trees, weights),
           params_to_numpy(r["states_t"][0]["params"]))
    fj, ft = flat(r["states_j"][0]["params"]), flat(params_to_numpy(
        r["states_t"][0]["params"]))
    for k in fj:
        np.testing.assert_allclose(ft[k], fj[k], atol=1e-6, rtol=0,
                                   err_msg=str(k))


def test_fl_secagg_compiled_matches_stepwise(clients):
    _, ta = adapters("tiny", False)
    out = {}
    for engine in ("stepwise", "compiled"):
        st = make_strategy("fl", ta, lambda: TO.adam(1e-3), 2,
                           privacy=PrivacyConfig(secagg=True, seed=3),
                           engine=engine, device="cpu")
        state, logs = st.run(st.setup(0), [c.train for c in clients],
                             np.random.default_rng(0), BATCH, 2)
        out[engine] = (st, state, logs)
    (sa, a, la), (sb, b, lb) = out["stepwise"], out["compiled"]
    prog = next(iter(sb._programs.values()))
    assert prog.bodies == ("step",) and len(sb._programs) == 1
    for x, y in zip(la, lb):
        np.testing.assert_allclose(y.losses, x.losses, atol=1e-5, rtol=0)
    fa, fb = flat(a["params"]), flat(b["params"])
    for k in fa:
        np.testing.assert_allclose(fb[k], fa[k], atol=1e-5, rtol=0)
    assert sa.secagg.summary() == sb.secagg.summary()
    assert sb.secagg.rounds == 2


def test_leakage_probes_match_repro():
    rng = np.random.default_rng(3)
    z = rng.standard_normal((24, 40)).astype(np.float32)
    x = (z[:, :8] @ rng.standard_normal((8, 12)) + 0.1 * rng.standard_normal(
        (24, 12))).astype(np.float32)
    labels = (z[:, 0] + 0.3 * rng.standard_normal(24) > 0).astype(np.float32)
    assert abs(TL.distance_correlation(z, x)
               - JL.distance_correlation(z, x)) <= 1e-6
    pj, pt = JL.reconstruction_probe(z, x), TL.reconstruction_probe(z, x)
    assert pj.keys() == pt.keys()
    for k in pj:
        assert abs(pt[k] - pj[k]) <= 1e-6, k
    assert abs(TL.label_probe_auc(z, labels)
               - JL.label_probe_auc(z, labels)) <= 1e-6


@pytest.mark.parametrize("noise", [False, True], ids=["clean", "noised"])
def test_measure_leakage_matches_repro(monkeypatch, clients, noise):
    ja, ta = adapters("tiny", False)
    pj = ja.init(jax.random.key(0))
    pt = params_from_jax(jax.tree.map(np.asarray, pj))
    batch = clients[0].test
    assert len(np.unique(batch["label"] > 0.5)) == 2
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    priv = ((JPrivacy(cut_noise_std=0.5), PrivacyConfig(cut_noise_std=0.5))
            if noise else (None, None))
    zj = JL.smashed_activations(ja, pj, batch, JTransport("identity"),
                                priv[0])
    zt = TL.smashed_activations(ta, pt, tb, Transport("identity",
                                                      device="cpu"), priv[1])
    assert zt.shape == zj.shape and zt.dtype == np.float32
    if noise:       # other streams: the same noise statistics
        clean = TL.smashed_activations(ta, pt, tb)
        assert abs(float((zt - clean).std()) / 0.5 - 1) < 0.05
    else:
        np.testing.assert_allclose(zt, zj, atol=1e-5, rtol=0)
    # the metrics on the same activations
    monkeypatch.setattr(TL, "smashed_activations", lambda *a, **k: zj)
    mj = JL.measure_leakage(ja, pj, batch, privacy=priv[0])
    mt = TL.measure_leakage(ta, pt, tb, privacy=priv[1])
    fj, ft = flat(mj), flat(mt)
    assert list(fj) == list(ft)
    for k in fj:
        assert abs(float(ft[k]) - float(fj[k])) <= 1e-6, k
