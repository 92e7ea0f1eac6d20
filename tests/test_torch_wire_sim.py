"""The port's wire simulator and the rest of ``wire/`` against ``repro``,
on the CPU.

* ``simulate`` EXACTLY equal to the reference's (wall clock, per-tag bytes,
  per-client stats, every event) for every method of ``METHODS``, LS and
  NLS, under the four codecs and the three network scenarios, at the
  paper-scale hospital sizes of ``benchmarks/wire_sweep.py`` on the tiny
  DenseNet of ``tests/test_system.py`` (the simulator is host code over
  byte counts, so exact is the bar).
* ``timeline_from_accounting`` from the port's own stepwise and compiled
  runs equal to the reference's from its own run (mirroring
  ``tests/test_wire.py``'s engine-independence gate), and an E-epoch run
  replaying to E x the per-epoch profile.
* ``straggler_sensitivity`` equal; ``replay``'s cycle error and the unknown
  method kind.
* ``Codec.error`` within 1e-6 relative, ``compression_ratio`` equal,
  ``Transport.reset``, and ``boundary_error`` on the tiny DenseNet (the
  same converted params and batch) within 1e-6 absolute + 1e-5 relative:
  the two packages' activations of order 1 agree to about 1e-7, and each
  error measure moves with them by that much (max_abs of the bf16 link
  at the U-shaped split's second crossing: 2.4e-7).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.core.partition import cnn_adapter as j_cnn_adapter
from repro.core.strategies import METHODS
from repro.core.strategies import make_strategy as j_make_strategy
from repro.models.cnn import DenseNetConfig as JDenseNetConfig
from repro.models.cnn import build_densenet as j_build_densenet
from repro.wire import CODECS
from repro.wire import Transport as JTransport
from repro.wire import boundary_error as j_boundary_error
from repro.wire import make_codec as j_make_codec
from repro.wire import simulate as j_simulate
from repro.wire import straggler_sensitivity as j_straggler_sensitivity
from repro.wire import timeline_from_accounting as j_timeline
from repro_torch import optim as TO
from repro_torch.core.comm import comm_per_epoch
from repro_torch.core.partition import cnn_adapter
from repro_torch.core.strategies import make_strategy
from repro_torch.interop import params_from_jax
from repro_torch.models.cnn import DenseNetConfig, build_densenet
from repro_torch.wire import (SCENARIOS, Transfer, Transport, boundary_error,
                              build_transfers, make_codec, replay, simulate,
                              straggler_sensitivity,
                              timeline_from_accounting)

torch.set_num_threads(2)

TINY = dict(growth=4, blocks=(1, 1), stem_ch=8, cut_layer=1)
# benchmarks/wire_sweep.py's hospitals (the paper's five-site split)
N_TRAIN = [472, 236, 110, 472, 236]
N_VAL = [118, 59, 28, 118, 59]
BATCH = 32


def _adapters(nls=False):
    return (j_cnn_adapter(j_build_densenet(JDenseNetConfig(**TINY), nls=nls)),
            cnn_adapter(build_densenet(DenseNetConfig(**TINY), nls=nls)))


def _example(n=BATCH, size=16):
    return {"image": np.zeros((n, size, size, 1), np.float32),
            "label": np.zeros((n,), np.float32)}


def _same(a, b):
    """Two SimResults equal in every field, events included."""
    assert (a.method, a.codec, a.scenario, a.n_clients) == (
        b.method, b.codec, b.scenario, b.n_clients)
    assert a.wall_clock_s == b.wall_clock_s
    assert a.bytes_on_wire == b.bytes_on_wire
    assert a.bytes_raw == b.bytes_raw
    assert a.breakdown == b.breakdown
    assert a.per_client == b.per_client
    assert [dataclasses.astuple(e) for e in a.events] == [
        dataclasses.astuple(e) for e in b.events]


@pytest.mark.parametrize("nls", [False, True], ids=["LS", "NLS"])
@pytest.mark.parametrize("method", METHODS)
def test_simulate_equals_reference(method, nls):
    ja, ta = _adapters(nls)
    ex = _example()
    for codec in CODECS:
        for scenario in SCENARIOS:
            j = j_simulate(method, ja, ex, N_TRAIN, N_VAL, BATCH, codec,
                           scenario, seed=7)
            t = simulate(method, ta, ex, N_TRAIN, N_VAL, BATCH, codec,
                         scenario, seed=7)
            _same(j, t)
            if method not in ("centralized",):
                assert t.wall_clock_s > 0 and t.events


@pytest.mark.parametrize("method", ["sflv3_ac", "fl", "sl_am"])
def test_straggler_sensitivity_equals_reference(method):
    ja, ta = _adapters()
    ex = _example()
    for scenario in ("hospital_wan", "cellular"):
        j = j_straggler_sensitivity(method, ja, ex, N_TRAIN, N_VAL, BATCH,
                                    "int8", scenario, seed=3)
        t = straggler_sensitivity(method, ta, ex, N_TRAIN, N_VAL, BATCH,
                                  "int8", scenario, seed=3)
        assert j == t and t >= 1.0


def _train_data():
    n = [24, 16, 8]
    return n, [{"image": np.random.default_rng(c).normal(
        0, 1, (nn, 16, 16, 1)).astype(np.float32),
        "label": (np.arange(nn) % 2).astype(np.float32)}
        for c, nn in enumerate(n)]


@pytest.mark.parametrize("method", ["sl_am", "sflv2_ac", "sflv3_ac"])
def test_timeline_from_accounting_equals_reference(method):
    """The port's stepwise and compiled runs replay to the reference's
    timeline of its own run, and to ``simulate`` (identity codec, same
    seed)."""
    n, data = _train_data()
    bs, n_val = 8, [8, 8, 8]
    ja, ta = _adapters()
    jtp = JTransport("identity")
    jst = j_make_strategy(method, ja, lambda: JO.adam(1e-3), 3,
                          transport=jtp)
    jst.run(jst.setup(jax.random.key(0)), data, np.random.default_rng(0),
            bs, 1)
    want = j_timeline(jtp, n_val=n_val, batch_size=bs,
                      network="hospital_wan", seed=3)
    eb = {k: v[:bs] for k, v in data[0].items()}
    sim = simulate(method, ta, eb, n, n_val, bs, "identity", "hospital_wan",
                   seed=3)
    for engine in ("stepwise", "compiled"):
        tp = Transport("identity", device="cpu")
        st = make_strategy(method, ta, lambda: TO.adam(1e-3), 3,
                           transport=tp, engine=engine, device="cpu")
        st.run(st.setup(0), data, np.random.default_rng(0), bs, 1)
        assert len(tp.epoch_log) == 1
        got = timeline_from_accounting(tp, n_val=n_val, batch_size=bs,
                                       network="hospital_wan", seed=3)
        _same(want, got)
        assert got.wall_clock_s == sim.wall_clock_s
        assert got.breakdown == sim.breakdown
        assert got.bytes_raw == sim.bytes_raw


def test_timeline_from_accounting_multi_epoch_bytes():
    n, data = _train_data()
    bs, E, n_val = 8, 3, [8, 8, 8]
    _, ta = _adapters()
    tp = Transport("identity", device="cpu")
    st = make_strategy("sl_am", ta, lambda: TO.adam(1e-3), 3, transport=tp,
                       device="cpu")
    st.run(st.setup(0), data, np.random.default_rng(0), bs, E)
    assert len(tp.epoch_log) == E
    eb = {k: v[:bs] for k, v in data[0].items()}
    full = comm_per_epoch("sl_am", ta, eb, n, n_val, bs)
    with_val = timeline_from_accounting(tp, n_val=n_val, batch_size=bs,
                                        network="lan", keep_events=False)
    assert with_val.bytes_on_wire == E * full.bytes_per_epoch
    assert with_val.events == []
    train_only = timeline_from_accounting(tp, network="lan")
    assert train_only.bytes_on_wire == E * sum(
        v for k, v in full.breakdown.items() if not k.startswith("val_"))
    assert tp.bytes_on_wire == train_only.bytes_on_wire
    with pytest.raises(ValueError, match="batch_size"):
        timeline_from_accounting(tp, n_val=n_val)


def test_timeline_of_an_empty_transport():
    r = timeline_from_accounting(Transport("identity", device="cpu"),
                                 network="lan")
    assert r.bytes_on_wire == 0 and r.wall_clock_s == 0
    assert np.isnan(r.compression_ratio)


def test_replay_errors():
    net = SCENARIOS["lan"]
    cyc = [Transfer(0, 0, 10.0, "up", "train_act_up", (1,)),
           Transfer(1, 0, 10.0, "down", "train_grad_down", (0,))]
    with pytest.raises(RuntimeError, match="cycle"):
        replay(cyc, net, 1)
    _, ta = _adapters()
    with pytest.raises(KeyError, match="unknown method kind"):
        build_transfers("swarm_ac", ta, _example(), [64], [32], BATCH)
    with pytest.raises(KeyError, match="unknown network"):
        simulate("fl", ta, _example(), [64], [32], BATCH, network="moon")


def test_codec_error_and_ratio_match_reference():
    x = np.random.default_rng(0).normal(0, 2, (6, 40)).astype(np.float32)
    x[2] = 0.0                                   # a zero row
    for name in CODECS:
        j = j_make_codec(name).error(x)
        t = make_codec(name).error(torch.from_numpy(x))
        assert j.keys() == t.keys()
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-6, atol=0)
        spec = jax.ShapeDtypeStruct((6, 40), np.float32)
        assert make_codec(name).compression_ratio(
            torch.empty((6, 40), device="meta")) == j_make_codec(
            name).compression_ratio(spec)
    assert make_codec("identity").error(torch.from_numpy(x))["max_abs"] == 0


def test_transport_reset():
    n, data = _train_data()
    _, ta = _adapters()
    tp = Transport("int8", device="cpu")
    st = make_strategy("sflv3_ac", ta, lambda: TO.adam(1e-3), 3,
                       transport=tp, device="cpu")
    st.run(st.setup(0), data, np.random.default_rng(0), 8, 1)
    assert tp.bytes_on_wire > 0 and tp.steps > 0 and tp.epoch_log
    tp.reset()
    assert (tp.bytes_on_wire, tp.bytes_raw, tp.steps, tp.epoch_log) == (
        0.0, 0.0, 0, [])
    assert np.isnan(tp.compression_ratio)


@pytest.mark.parametrize("nls", [False, True], ids=["LS", "NLS"])
def test_boundary_error_matches_reference(nls):
    ja, ta = _adapters(nls)
    jp = ja.init(jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(1).normal(0, 1, (4, 16, 16, 1)).astype(
        np.float32)
    batch = {"image": x, "label": np.zeros((4,), np.float32)}
    for codec in ("int8", "bf16", "topk:0.1"):
        j = j_boundary_error(JTransport(codec), ja, jp, batch)
        t = boundary_error(Transport(codec, device="cpu"), ta, tp,
                           {k: torch.from_numpy(v) for k, v in batch.items()})
        assert list(t) == list(j) == (["front->", "middle->"] if nls
                                      else ["front->"])
        for key in j:
            assert len(t[key]) == len(j[key])
            for a, b in zip(t[key], j[key]):
                for k in b:
                    np.testing.assert_allclose(a[k], b[k], rtol=1e-5,
                                               atol=1e-6)
