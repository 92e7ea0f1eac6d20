"""Hospital-axis placement (``repro_torch.core.placement``, ``shard=True``)
in the port against ``repro``, on the CPU.

  * ``Placement.make`` against the reference's over a grid of hospital and
    device counts (one device, disabled, padded, even): ``enabled``,
    ``c_pad``, ``n_pad``, ``padded`` and ``client_weights`` equal;
    ``pad_tree`` in both modes and ``pad_rows`` equal to the reference's
    on the same numpy arrays (exactly);
  * ``engine.pack_epoch(pad_clients=2)`` against the reference's, array
    for array, exactly (``tests/test_placement.py``'s case);
  * forced padding without devices (``Placement(n, n + 2, None)``, the
    reference's ``tests/test_placement.py`` contract): the tiny DenseNet
    at 16x16, 3 hospitals of 17, 12 and 9 images, batch 4, Adam at 1e-4,
    2 epochs (``run_epoch`` twice, or one ``run``), both packages from the
    same converted weights and the same numpy batch order.  The padded
    port run against the port's unpadded run: losses and every hospital's
    params within 1e-5, step counts and loss weights equal, epsilon and
    wire bytes exactly equal.  The padded port run against the
    reference's padded run: the first 2 steps' losses within 1e-4 and
    every param within 1e-5 (the cross-package bars of
    ``tests/test_torch_engine_ref.py``, two epochs at lr 1e-4), epsilon
    within 1e-9 and wire bytes equal.  A private row's noise comes from
    each package's own generators, so against the reference it holds its
    first step's losses (1e-4) and its accounting only; against the
    port's unpadded run it holds everything.

Placement over virtual devices is ``tests/test_torch_placement_devices.py``.
"""

import jax
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.core.placement import Placement as JPlacement
from repro.core.strategies import engine as JENG
from repro.core.strategies import make_strategy as j_make_strategy
from repro.data.synthetic import make_cxr_clients
from repro.privacy import PrivacyConfig as JPrivacyConfig
from repro.wire import Transport as JTransport
from repro_torch import optim as TO
from repro_torch.core.placement import Placement
from repro_torch.core.strategies import engine as ENG
from repro_torch.core.strategies import make_strategy
from repro_torch.interop import params_to_numpy
from repro_torch.privacy import PrivacyConfig
from repro_torch.wire import Transport
from torch_grid_pair import adapters, flat, port_state

torch.set_num_threads(2)

SIZES, BATCH, LR, EPOCHS = [17, 12, 9], 4, 1e-4, 2
TOL, REF_LOSS_TOL = 1e-5, 1e-4
DP = dict(noise_multiplier=1.1, clip_norm=1.0)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, d, enabled", [
    (5, 1, True), (5, 4, False), (5, 4, True), (8, 4, True), (3, 4, True),
    (0, 4, True), (7, 3, True), (1, 2, True)])
def test_make_matches_the_reference(n, d, enabled):
    j = JPlacement.make(n, enabled=enabled, devices=[object()] * d)
    t = Placement.make(n, enabled=enabled,
                       devices=[torch.device("cpu")] * d)
    assert (t.enabled, t.padded, t.c_pad, t.n_pad) == (
        j.enabled, j.padded, j.c_pad, j.n_pad)
    np.testing.assert_array_equal(t.client_weights(), j.client_weights())
    if t.enabled:
        chunks = t.chunks(torch.device("cpu"))
        assert len(chunks) == d
        assert [g for ch in chunks for g in ch.ids] == list(range(t.c_pad))
        assert [ch.index for ch in chunks] == list(range(d))


def test_pad_tree_and_rows_match_the_reference():
    j, t = JPlacement(3, 5, None), Placement(3, 5, None)
    tree = {"w": np.arange(6, dtype=np.float32).reshape(3, 2),
            "s": np.ones((7,), np.float32)}
    for mode in ("edge", "zeros"):
        a, b = j.pad_tree(tree, mode=mode), t.pad_tree(tree, mode=mode)
        for k in tree:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        c = t.pad_tree({k: torch.from_numpy(v) for k, v in tree.items()},
                       mode=mode)
        for k in tree:
            np.testing.assert_array_equal(c[k].numpy(), np.asarray(a[k]))
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    np.testing.assert_array_equal(t.pad_rows(x), j.pad_rows(x))
    # one device: identities
    one = Placement.make(5, devices=[torch.device("cpu")])
    y = np.ones((5, 3))
    assert one.put(y) is y and one.pad_tree({"a": y})["a"] is y


def test_put_and_specs_split_the_hospital_axis():
    t = Placement.make(5, devices=[torch.device("cpu")] * 4)
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    tree = t.put({"x": x, "server": torch.ones(3)})
    assert len(tree["x"]) == 4 and tree["server"].shape == (3,)
    for k, part in enumerate(tree["x"]):
        assert part.device == torch.device("cpu")
        torch.testing.assert_close(part, x[2 * k:2 * k + 2], rtol=0, atol=0)
    assert t.sharding((8, 3)).spec == ("hosp",)
    assert t.sharding((8, 3)).shard_shape((8, 3)) == (2, 3)
    assert t.sharding((3, 8), axis=1).spec == (None, "hosp")
    assert t.leaf_specs({"a": x, "n": torch.zeros(())}) == {
        "a": ("hosp",), "n": ()}
    assert t.tree_shardings({"a": x})["a"].spec == ("hosp",)


def test_pack_epoch_pad_clients_is_the_references():
    data = [{"x": np.arange(10, dtype=np.float32)[:, None],
             "label": np.arange(10)},
            {"x": np.arange(5, dtype=np.float32)[:, None],
             "label": np.arange(5)}]
    for drop in (True, False):
        j = JENG.pack_epoch(data, 2, np.random.default_rng(3), drop,
                            pad_clients=2)
        t = ENG.pack_epoch(data, 2, np.random.default_rng(3), drop,
                           pad_clients=2)
        for k in j.batches:
            np.testing.assert_array_equal(t.batches[k], j.batches[k])
        np.testing.assert_array_equal(t.mask, j.mask)
        if j.ex_weights is not None:
            np.testing.assert_array_equal(t.ex_weights, j.ex_weights)
        assert (t.n_batches, t.n_samples, t.step_examples,
                t.total_steps) == (j.n_batches, j.n_samples,
                                   j.step_examples, j.total_steps)
    assert not t.batches["x"][2:].any() and not t.mask[2:].any()


# ---------------------------------------------------------------------------
# forced padding: phantom hospitals change nothing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, train_per_client=SIZES, val_per_client=6,
                            test_per_client=7, image_size=16, n_clients=3)


@pytest.fixture(scope="module")
def adapter_pair():
    return adapters("tiny", False)


def _run(pkg, method, adapter, clients, pad, privacy, codec, whole, start):
    n = len(clients)
    if pkg == "ref":
        tr = None if codec is None else JTransport(codec)
        st = j_make_strategy(method, adapter, lambda: JO.adam(LR), n,
                             privacy=None if privacy is None
                             else JPrivacyConfig(**privacy), transport=tr)
        if pad:
            st.placement = JPlacement(n, n + 2, None)
        state = st.setup(jax.random.key(0))
    else:
        tr = None if codec is None else Transport(codec, device="cpu")
        st = make_strategy(method, adapter, lambda: TO.adam(LR), n,
                           privacy=None if privacy is None
                           else PrivacyConfig(**privacy), transport=tr,
                           device="cpu")
        if pad:
            st.placement = Placement(n, n + 2, None)
        state = port_state(method, start)
    data, rng = [c.train for c in clients], np.random.default_rng(1)
    if whole:
        state, logs = st.run(state, data, rng, BATCH, EPOCHS)
    else:
        logs = []
        for _ in range(EPOCHS):
            state, log = st.run_epoch(state, data, rng, BATCH)
            logs.append(log)
    params = [flat(params_to_numpy(st.params_for_eval(state, i))
                   if pkg == "port" else st.params_for_eval(state, i))
              for i in range(n)]
    return dict(st=st, state=state, logs=logs, params=params, tr=tr,
                eps=[r["epsilon"] for r in st.privacy_report()],
                steps=[r["steps"] for r in st.privacy_report()])


PADDED = [("fl", None, None, False), ("fl", None, None, True),
          ("sflv2_ac", None, None, False), ("sflv2_ac", None, None, True),
          ("sflv3_ac", None, None, False), ("sflv3_ac", None, None, True),
          ("fl", DP, None, False), ("sflv3_ac", DP, None, False),
          ("sl_am", None, "identity", False)]


@pytest.mark.parametrize("method, privacy, codec, whole", PADDED,
                         ids=["fl", "fl-run", "sflv2", "sflv2-run", "sflv3",
                              "sflv3-run", "fl-dp", "sflv3-dp", "sl_am-wire"])
def test_phantom_hospitals_change_nothing(method, privacy, codec, whole,
                                          clients, adapter_pair):
    ja, ta = adapter_pair
    sj = j_make_strategy(method, ja, lambda: JO.adam(LR), len(clients))
    start = jax.tree.map(np.asarray, sj.setup(jax.random.key(0)))
    args = (clients, True, privacy, codec, whole, start)
    ref = _run("ref", method, ja, *args)
    pad = _run("port", method, ta, *args)
    plain = _run("port", method, ta, clients, False, privacy, codec, whole,
                 start)
    assert pad["st"].placement.padded and not pad["st"].placement.enabled
    for a, b, r in zip(plain["logs"], pad["logs"], ref["logs"]):
        np.testing.assert_allclose(b.losses, a.losses, atol=TOL, rtol=0)
        assert (b.steps, b.weights, b.client_steps) == (
            a.steps, a.weights, a.client_steps)
        assert (b.steps, b.weights, b.client_steps) == (
            r.steps, r.weights, r.client_steps)
    # the two packages draw their DP noise from different generators: a
    # private row meets the reference on its first steps' losses (drawn
    # before any noise lands) and its accounting only
    per_step = len(ref["logs"][0].losses) // ref["logs"][0].steps
    first = slice(0, (1 if privacy else 2) * per_step)
    np.testing.assert_allclose(pad["logs"][0].losses[first],
                               ref["logs"][0].losses[first],
                               atol=REF_LOSS_TOL, rtol=0)
    for pa, pb, pr in zip(plain["params"], pad["params"], ref["params"]):
        assert pa.keys() == pb.keys() == pr.keys()
        for k in pa:
            np.testing.assert_allclose(pb[k], pa[k], atol=TOL, rtol=0)
            if privacy is None:
                np.testing.assert_allclose(pb[k], np.asarray(pr[k]),
                                           atol=TOL, rtol=0)
    assert pad["eps"] == plain["eps"] and pad["steps"] == plain["steps"]
    assert pad["steps"] == ref["steps"]
    np.testing.assert_allclose(pad["eps"], ref["eps"], atol=1e-9, rtol=0)
    if codec is not None:
        assert pad["tr"].bytes_on_wire > 0
        assert (pad["tr"].steps, pad["tr"].bytes_on_wire) == (
            plain["tr"].steps, plain["tr"].bytes_on_wire) == (
            ref["tr"].steps, ref["tr"].bytes_on_wire)


def test_padded_scores_match(clients, adapter_pair):
    """``scores_all`` after a padded run: the unpadded run's scores and the
    reference's padded run's, each within 1e-5."""
    ja, ta = adapter_pair
    sj = j_make_strategy("sflv3_ac", ja, lambda: JO.adam(LR), len(clients))
    start = jax.tree.map(np.asarray, sj.setup(jax.random.key(0)))
    datas = [c.test for c in clients]
    scores = {}
    for key, pkg, ad, pad in (("ref", "ref", ja, True),
                              ("pad", "port", ta, True),
                              ("plain", "port", ta, False)):
        r = _run(pkg, "sflv3_ac", ad, clients, pad, None, None, False, start)
        scores[key] = r["st"].scores_all(r["state"], datas, batch_size=4)
    for a, b, r in zip(scores["plain"], scores["pad"], scores["ref"]):
        assert a.shape == b.shape == np.asarray(r).shape
        np.testing.assert_allclose(b, a, atol=TOL, rtol=0)
        np.testing.assert_allclose(b, np.asarray(r), atol=TOL, rtol=0)
