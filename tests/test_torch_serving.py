"""The port's train→deploy loop (``repro_torch.serving``,
``train.checkpoint``, ``obs.trace``) on the CPU, mirroring
``tests/test_serving_service.py`` and held against ``repro``.

* ``Strategy.export`` scores bit-equal to the port's ``Strategy.scores``
  for every method in both training precisions (one function, one grid),
  distinct heads per hospital, and the export of the reference's state
  (converted) within 1e-5 of the reference's export.
* The file round trip: the port's ``save_servable`` and ``checkpoint.save``
  files byte-equal to the reference's of the same converted params, each
  package loading the other's; missing keys and a shape mismatch raise.
* ``chunk_batches`` bit-equal to the single transfer.
* ``BucketScorer``: no capture after construction (the CPU captures
  none; one per bucket on the card is phase 13 of ``chip_smoke.py``),
  f32 scores within 1e-5 of ``Strategy.scores`` (a bucket's batch size
  differs from the eval grid's), bf16 within 0.05 (the reference's bar),
  a mismatched swap rejected, and threads hammering ``score`` during
  swaps seeing only the two models' scores.
* ``ScreeningService``: batching within 1e-5 of eval with trace spans,
  backpressure, and versions across a swap.
* ``Tracer`` spans, ``wire_events`` (equal to the reference's on the same
  simulation), ``merge_events`` and ``write_chrome_trace``.
"""

import concurrent.futures as cf
import json
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.core.partition import cnn_adapter as j_cnn_adapter
from repro.core.strategies import make_strategy as j_make_strategy
from repro.models.cnn import DenseNetConfig as JDenseNetConfig
from repro.models.cnn import build_densenet as j_build_densenet
from repro.obs import trace as j_trace
from repro.serving import load_servable as j_load_servable
from repro.serving import save_servable as j_save_servable
from repro.train import checkpoint as j_checkpoint
from repro.wire import simulate as j_simulate
from repro_torch import optim as TO
from repro_torch.core.partition import cast_adapter, cnn_adapter
from repro_torch.core.strategies import make_strategy
from repro_torch.data.synthetic import make_cxr_clients
from repro_torch.interop import full_state_from_jax, params_to_numpy
from repro_torch.models.cnn import DenseNetConfig, build_densenet
from repro_torch.obs import (PID_SERVING, Tracer, merge_events, wire_events,
                             write_chrome_trace)
from repro_torch.serving import (Backpressure, BucketScorer,
                                 ScreeningService, ServableModel,
                                 load_servable, save_servable)
from repro_torch.train import checkpoint
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.wire import simulate

torch.set_num_threads(2)

METHODS = ["centralized", "fl", "sl_ac", "sl_am", "sflv2_ac", "sflv3_ac",
           "sflv1_ac"]
TINY = dict(growth=4, blocks=(1, 1), stem_ch=8, cut_layer=1)
F32_BAR, BF16_BAR = 1e-5, 0.05


@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, train_per_client=[12, 9, 8],
                            val_per_client=4, test_per_client=13,
                            image_size=16, n_clients=3)


def _adapter(cfg=TINY, precision="fp32"):
    return cast_adapter(cnn_adapter(build_densenet(DenseNetConfig(**cfg))),
                        precision)


def _trained(method, clients, precision="fp32", seed=0):
    st = make_strategy(method, _adapter(precision=precision),
                       lambda: TO.adam(1e-3), len(clients), device="cpu")
    state, _ = st.run_epoch(st.setup(seed), [c.train for c in clients],
                            np.random.default_rng(0), 4)
    return st, state


def _equal_trees(a, b):
    """Same paths, and bit-equal tensors (of one dtype) at each."""
    fa, fb = dict(checkpoint.tree_paths(a)), dict(checkpoint.tree_paths(b))
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k])
                                          for k in fa)


# -- export --------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_export_scores_bit_equal(method, precision, clients):
    st, state = _trained(method, clients, precision)
    for i in range(len(clients)):
        ref = st.scores(state, i, clients[i].test, batch_size=5)
        sv = st.export(state, client_idx=i)
        np.testing.assert_array_equal(
            ref, sv.scores(clients[i].test, batch_size=5))
        assert sv.meta == {"strategy": st.name, "client_idx": i,
                           "n_clients": 3}
        assert sv.shared == (method in ("centralized", "fl"))
        assert sv.family == st.adapter.name


def test_export_distinct_heads(clients):
    st, state = _trained("sflv3_ac", clients)
    s0 = st.export(state, 0).scores(clients[0].test, 5)
    s1 = st.export(state, 1).scores(clients[0].test, 5)
    assert not np.array_equal(s0, s1)


def test_export_is_a_snapshot(clients):
    st, state = _trained("fl", clients)
    sv = st.export(state)
    before = sv.scores(clients[0].test, 5)
    st.run_epoch(state, [c.train for c in clients], np.random.default_rng(1),
                 4)
    np.testing.assert_array_equal(before, sv.scores(clients[0].test, 5))


@pytest.fixture(scope="module")
def reference_export():
    """The reference's FL strategy at its seed-0 init and its export, with
    the port's strategy on the converted state."""
    ja = j_cnn_adapter(j_build_densenet(JDenseNetConfig(**TINY)))
    jst = j_make_strategy("fl", ja, lambda: JO.adam(1e-3), 3)
    jstate = jst.setup(jax.random.key(0))
    st = make_strategy("fl", _adapter(), lambda: TO.adam(1e-3), 3,
                       device="cpu")
    state = full_state_from_jax(jax.tree.map(np.asarray, jstate))
    return ja, jst, jstate, st, state


def test_export_matches_reference(reference_export, clients):
    ja, jst, jstate, st, state = reference_export
    data = clients[0].test
    want = np.asarray(jst.export(jstate).scores(data, 5))
    got = st.export(state).scores(data, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_BAR)


# -- files ---------------------------------------------------------------------

def test_servable_file_byte_equal_to_reference(reference_export, tmp_path):
    ja, jst, jstate, st, state = reference_export
    jsv = jst.export(jstate, meta={"round": 7})
    sv = st.export(state, meta={"round": 7})
    j_path, t_path = tmp_path / "ref.msgpack", tmp_path / "port.msgpack"
    j_save_servable(str(j_path), jsv)
    save_servable(str(t_path), sv)
    assert t_path.read_bytes() == j_path.read_bytes()
    # each package loads the other's file
    back = load_servable(str(j_path), st.adapter, device="cpu")
    assert _equal_trees(back.params, sv.params)
    assert back.meta == sv.meta and back.shared == sv.shared is True
    jback = j_load_servable(str(t_path), ja)
    for a, b in zip(jax.tree.leaves(jback.params),
                    jax.tree.leaves(jsv.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_file_byte_equal_to_reference(reference_export,
                                                 tmp_path):
    _, _, jstate, _, state = reference_export
    j_path, t_path = tmp_path / "ref.ckpt", tmp_path / "port.ckpt"
    j_checkpoint.save(str(j_path), jstate["params"])
    checkpoint.save(str(t_path), state["params"])
    assert t_path.read_bytes() == j_path.read_bytes()
    assert _equal_trees(checkpoint.load(str(j_path), state["params"]),
                        state["params"])
    for a, b in zip(jax.tree.leaves(j_checkpoint.load(str(t_path),
                                                      jstate["params"])),
                    jax.tree.leaves(jstate["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_servable_roundtrip(tmp_path, clients):
    st, state = _trained("sflv3_ac", clients)
    sv = st.export(state, client_idx=2, meta={"round": 7})
    p = str(tmp_path / "model.msgpack")
    save_servable(p, sv)
    sv2 = load_servable(p, st.adapter, device="cpu")
    assert sv2.meta == {"strategy": "sflv3_ac", "client_idx": 2,
                        "n_clients": 3, "round": 7}
    assert sv2.shared == sv.shared is False
    assert _equal_trees(sv2.params, sv.params)
    np.testing.assert_array_equal(sv.scores(clients[2].test, 5),
                                  sv2.scores(clients[2].test, 5))


def test_load_servable_missing_keys_and_mismatch(tmp_path, clients):
    st, state = _trained("fl", clients)
    sv = st.export(state)
    p = str(tmp_path / "model.msgpack")
    save_servable(p, sv)
    wider = _adapter(dict(TINY, growth=8))
    with pytest.raises(ValueError, match="mismatch"):
        load_servable(p, wider, device="cpu")
    save_servable(p, ServableModel(sv.adapter, {"front": sv.params["front"]},
                                   True))
    with pytest.raises(ValueError, match="lacks params"):
        load_servable(p, st.adapter, device="cpu")


def test_checkpoint_roundtrip_of_a_whole_state(tmp_path, clients):
    st, state = _trained("sflv3_ac", clients)
    p = str(tmp_path / "state.ckpt")
    checkpoint.save(p, state)
    back = checkpoint.load(p, state)
    assert _equal_trees(back, state)
    assert back["c_opts"][1]["step"].dtype == torch.int64
    bf = tree_map(lambda t: t.to(torch.bfloat16)
                  if t.is_floating_point() else t, state["server"])
    checkpoint.save(p, bf)
    assert _equal_trees(checkpoint.load(p, bf), bf)
    # the file's conv weights are HWIO, as the reference's
    recs = checkpoint.unpackb(open(p, "rb").read())
    conv = next(k for k, v in checkpoint.tree_paths(bf) if v.dim() == 4)
    assert tuple(recs[conv]["shape"]) == params_to_numpy(
        dict(checkpoint.tree_paths(state["server"])))[conv].shape


# -- chunked eval --------------------------------------------------------------

@pytest.mark.parametrize("method", ["fl", "sflv3_ac"])
def test_chunked_eval_bit_equal(method, clients):
    st, state = _trained(method, clients)
    datas = [c.test for c in clients]
    ref_all = st.scores_all(state, datas, batch_size=4)
    for ch in (1, 2, 100):
        for r, g in zip(ref_all, st.scores_all(state, datas, batch_size=4,
                                               chunk_batches=ch)):
            np.testing.assert_array_equal(r, g)
    np.testing.assert_array_equal(
        st.scores(state, 1, datas[1], batch_size=4),
        st.scores(state, 1, datas[1], batch_size=4, chunk_batches=2))
    with pytest.raises(ValueError, match="chunk_batches"):
        st.scores(state, 1, datas[1], batch_size=4, chunk_batches=0)


# -- scoring core --------------------------------------------------------------

def test_scorer_never_captures_after_construction(clients):
    st, state = _trained("fl", clients)
    sv = st.export(state)
    img = clients[0].test["image"]
    sc = BucketScorer(sv, image_shape=img.shape[1:], buckets=(4, 1, 2, 2))
    assert sc.buckets == (1, 2, 4) and sorted(sc._progs) == [1, 2, 4]
    built = sc.n_compiles
    ref = st.scores(state, 0, clients[0].test, batch_size=5)
    for n in (1, 2, 3, 4, 5, 9, 13):
        got, info = sc.score({"image": img[:n]})
        assert got.dtype == np.float32 and got.shape == (n,)
        np.testing.assert_allclose(got, ref[:n], rtol=0, atol=F32_BAR)
        assert info["n_dispatch"] == -(-n // 4)
        assert info["buckets"][-1] == sc.bucket_for(n - 4 * (-(-n // 4) - 1))
        assert info["version"] == 0
    assert sc.n_compiles == built
    assert sc.n_dispatches == sum(-(-n // 4) for n in (1, 2, 3, 4, 5, 9, 13))
    assert sc.score({"image": img[:0]})[0].shape == (0,)
    with pytest.raises(ValueError, match="example"):
        BucketScorer(sv)
    with pytest.raises(ValueError, match="positive"):
        BucketScorer(sv, image_shape=img.shape[1:], buckets=(0, 2))


def test_scorer_bf16_precision(clients):
    st, state = _trained("fl", clients)
    sv = st.export(state)
    img = clients[0].test["image"]
    sc = BucketScorer(sv, image_shape=img.shape[1:], buckets=(4,),
                      precision="bf16")
    assert all(l.dtype == torch.bfloat16 for l in tree_leaves(sc._params))
    got, _ = sc.score({"image": img[:4]})
    ref = st.scores(state, 0, clients[0].test, batch_size=5)[:4]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=BF16_BAR)
    with pytest.raises(ValueError, match="precision"):
        BucketScorer(sv, image_shape=img.shape[1:], precision="fp8")


def test_swap_rejects_mismatched_tree(clients):
    st, state = _trained("fl", clients)
    sv = st.export(state)
    sc = BucketScorer(sv, image_shape=clients[0].test["image"].shape[1:],
                      buckets=(1,))
    with pytest.raises(ValueError, match="structure"):
        sc.swap({"front": sv.params["front"]})
    with pytest.raises(ValueError, match="shapes"):
        sc.swap(tree_map(lambda l: np.zeros((3,), np.float32), sv.params))
    assert sc.version == 0


def test_swap_never_serves_torn_tree(clients):
    """Threads hammer ``score`` while another swaps between two param sets
    whose scores differ everywhere: every served score is bit-equal to ONE
    of the two models' (a torn tree would give a third value)."""
    st, state = _trained("fl", clients)
    sv0 = st.export(state)
    state2, _ = st.run_epoch(state, [c.train for c in clients],
                             np.random.default_rng(1), 4)
    sv1 = st.export(state2)
    img = clients[0].test["image"][:4]
    sc = BucketScorer(sv0, image_shape=img.shape[1:], buckets=(4,))
    a, _ = sc.score({"image": img})
    sc.swap(sv1)
    b, _ = sc.score({"image": img})
    assert not np.array_equal(a, b)

    stop = threading.Event()

    def swapper():
        flip = 0
        while not stop.is_set():
            sc.swap(sv0 if flip % 2 == 0 else sv1)
            flip += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t = threading.Thread(target=swapper)
    t.start()
    try:
        with cf.ThreadPoolExecutor(6) as ex:
            outs = list(ex.map(lambda _: sc.score({"image": img}),
                               range(60)))
    finally:
        stop.set()
        t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not t.is_alive()
    # odd versions hold sv1, even ones sv0: each call serves the version
    # it reports, whole
    for got, info in outs:
        want = a if info["version"] % 2 == 0 else b
        np.testing.assert_array_equal(got, want)
    assert sc.version >= 2


# -- batching front end --------------------------------------------------------

def test_service_batches_and_matches_eval(clients):
    st, state = _trained("fl", clients)
    sv = st.export(state)
    data = clients[0].test
    ref = st.scores(state, 0, data, batch_size=5)
    with ScreeningService(sv, image_shape=data["image"].shape[1:],
                          buckets=(1, 2, 4), max_wait_s=0.002,
                          trace=True) as svc:
        with cf.ThreadPoolExecutor(8) as ex:
            got = list(ex.map(
                lambda i: svc.score_one({"image": data["image"][i]}),
                range(len(ref))))
        stats = svc.stats()
        events = svc.trace_events()
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=F32_BAR)
    assert stats["n"] == len(ref)
    assert stats["total_p99_ms"] >= stats["total_p50_ms"] >= 0
    assert 1 <= stats["batch_n_mean"] <= 4
    names = {e["name"] for e in events}
    assert {"queue_wait", "dispatch", "pad", "readback"} <= names
    assert sum(e["name"] == "queue_wait" for e in events) == len(ref)
    assert all(e["pid"] == PID_SERVING for e in events)


def test_service_backpressure(clients):
    st, state = _trained("fl", clients)
    img = clients[0].test["image"]
    # queue cap (3) below the only bucket (4): the dispatcher cannot fire
    # before max_wait, so the 4th submission sheds
    with ScreeningService(st.export(state), image_shape=img.shape[1:],
                          buckets=(4,), max_wait_s=0.3, max_queue=3) as svc:
        reqs = [svc.submit({"image": img[0]}) for _ in range(3)]
        with pytest.raises(Backpressure):
            svc.submit({"image": img[0]})
        for r in reqs:
            assert r.done.wait(5)
        assert [r.lat["batch_n"] for r in reqs] == [3, 3, 3]
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit({"image": img[0]})


def test_service_hot_swap_versions(clients):
    st, state = _trained("fl", clients)
    sv0 = st.export(state)
    state2, _ = st.run_epoch(state, [c.train for c in clients],
                             np.random.default_rng(1), 4)
    img = clients[0].test["image"]
    with ScreeningService(sv0, image_shape=img.shape[1:], buckets=(1,),
                          max_wait_s=0.0) as svc:
        s0 = svc.score_one({"image": img[0]})
        assert svc.version == 0
        svc.swap(st.export(state2))
        assert svc.version == 1
        s1 = svc.score_one({"image": img[0]})
        direct, info = svc.score_batch({"image": img[:1]})
    assert s0 != s1 and direct[0] == np.float32(s1) and info["version"] == 1


# -- tracing -------------------------------------------------------------------

def test_tracer_spans_and_events():
    tr = Tracer()
    with tr.span("run", method="fl"):
        with tr.span("dispatch"):
            pass
    t0 = tr.now()
    tr.event("queue_wait", t0, t0 + 0.5, tid=2, n=3)
    assert [e["name"] for e in tr.events] == ["dispatch", "run",
                                              "queue_wait"]
    assert tr.find("run")["args"] == {"method": "fl", "depth": 0}
    assert tr.find("dispatch")["args"]["depth"] == 1
    assert tr.find("missing") is None
    q = tr.find("queue_wait")
    assert q["tid"] == 2 and abs(q["dur"] - 5e5) < 1e-3
    evs = tr.trace_events()
    assert evs[0]["ph"] == "M" and evs[2:] == tr.events


def test_wire_events_merge_and_write(tmp_path):
    ja = j_cnn_adapter(j_build_densenet(JDenseNetConfig(**TINY)))
    ta = _adapter()
    ex = {"image": np.zeros((8, 16, 16, 1), np.float32),
          "label": np.zeros((8,), np.float32)}
    args = ([24, 16, 8], [8, 8, 8], 8, "int8", "hospital_wan")
    t = wire_events(simulate("sflv3_ac", ta, ex, *args, seed=1), label="x")
    assert t == j_trace.wire_events(j_simulate("sflv3_ac", ja, ex, *args,
                                               seed=1), label="x")
    tr = Tracer()
    with tr.span("run"):
        pass
    merged = merge_events(tr.trace_events(), t, pid_offset=10)
    assert len(merged) == len(tr.trace_events()) + len(t)
    assert {e["pid"] for e in merged} == {11, 12}
    path = write_chrome_trace(merged, tmp_path / "trace.json")
    loaded = json.load(open(path))
    assert loaded["traceEvents"] == merged
    assert loaded["displayTimeUnit"] == "ms"
