"""The Table-2 grid's wire and accounting in the port against ``repro``, on
the CPU, stepwise, and what the grid refuses.

* Every split row of ``benchmarks/repro_tables.ROWS`` over
  ``Transport("int8")`` fused (K3's plain version here) on the tiny
  DenseNet of ``tests/test_system.py``: the first 2 steps' losses within
  1e-4 (later steps are not held: a cut-tensor element within round-off
  of a half level lands on the neighbouring int8 level in one package,
  and Adam turns that into another update, as ``test_torch_sflv3.py``
  explains), and the wire bytes, step counts and each epoch's schedule
  signature exactly equal.
* ``comm_per_epoch`` exactly equal for every row on ``DENSENET_MINI`` and
  ``UNET_MINI`` at 32x32, with and without the int8 codec (the U-Net NLS
  rows' ``middle->tail`` legs included).
* ``drop_remainder=False``: SL, FL and centralized keep each hospital's
  short final batch, step for step as the reference does (losses within
  1e-4, batch sizes equal); SFLv3/v1 refuse it with the reference's
  message.
"""

import functools

import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.core.comm import comm_per_epoch as j_comm_per_epoch
from repro.core.strategies import make_strategy as j_make_strategy
from repro.data.synthetic import make_cxr_clients
from repro.wire import make_codec as j_make_codec
from repro_torch import optim as TO
from repro_torch.core.comm import comm_per_epoch
from repro_torch.core.strategies import make_strategy
from repro_torch.privacy import PrivacyConfig
from repro_torch.wire import Transport, make_codec
from torch_grid_pair import adapters, load, run_pair

torch.set_num_threads(2)

BATCH, LR, TOL = 8, 1e-4, 1e-4
ROWS = load("benchmarks/repro_tables.py").ROWS
SPLIT_ROWS = [r for r in ROWS if r[1] not in ("centralized", "fl")]


@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, train_per_client=32, val_per_client=16,
                            test_per_client=16, image_size=16)


@pytest.fixture(scope="module")
def runs(clients):
    return {label: run_pair(method, nls, "tiny", clients, BATCH, LR, "int8")
            for label, method, nls in SPLIT_ROWS}


@pytest.mark.parametrize("label", [r[0] for r in SPLIT_ROWS])
def test_first_steps_over_the_int8_link_match_repro(runs, label):
    lj, lt = runs[label]["logs_j"][0], runs[label]["logs_t"][0]
    assert (lt.steps, lt.client_steps) == (lj.steps, lj.client_steps)
    first = slice(0, 2 * len(lj.losses) // lj.steps)
    assert np.isfinite(lt.losses).all()
    np.testing.assert_allclose(lt.losses[first], lj.losses[first], atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("label", [r[0] for r in SPLIT_ROWS])
def test_wire_bytes_equal_repro(runs, label):
    tj, tt = runs[label]["tj"], runs[label]["tt"]
    assert tt.steps == tj.steps > 0
    assert tt.bytes_on_wire == tj.bytes_on_wire > 0
    assert tt.summary() == tj.summary()
    assert len(tt.epoch_log) == len(tj.epoch_log) == 1
    ej, et = tj.epoch_log[0], tt.epoch_log[0]
    assert (et.kind, et.schedule, et.tr_counts, et.legs, et.nls) == \
        (ej.kind, ej.schedule, ej.tr_counts, ej.legs, ej.nls)
    assert et.nls == ("NLS" in label)


@functools.lru_cache(maxsize=None)
def _adapters(arch, nls):
    return adapters(arch, nls)


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("arch", ["densenet-mini", "unet-mini"])
@pytest.mark.parametrize("label, method, nls", ROWS, ids=[r[0] for r in ROWS])
def test_comm_per_epoch_equals_repro(label, method, nls, arch, codec):
    ja, ta = _adapters(arch, nls)
    rng = np.random.default_rng(0)
    example = {"image": rng.standard_normal((BATCH, 32, 32, 1)).astype(
        np.float32), "label": np.zeros((BATCH,), np.float32)}
    n_tr, n_va = [40, 16, 24, 16, 24], [60] * 5
    pj = j_comm_per_epoch(method, ja, example, n_tr, n_va, BATCH,
                          codec=codec and j_make_codec(codec))
    pt = comm_per_epoch(method, ta, example, n_tr, n_va, BATCH,
                        codec=codec and make_codec(codec))
    assert pt.bytes_per_epoch == pj.bytes_per_epoch
    assert pt.breakdown == pj.breakdown
    assert ("train_hidden_down" in pt.breakdown) == (
        nls and method not in ("centralized", "fl"))


@pytest.mark.parametrize("method", ["sl_am", "fl", "centralized"])
def test_short_batches_kept_as_repro_keeps_them(method):
    uneven = make_cxr_clients(seed=0, train_per_client=[12, 8, 10, 5, 10],
                              val_per_client=4, test_per_client=4,
                              image_size=16)
    codec = None if method in ("centralized", "fl") else "identity"
    r = run_pair(method, False, "tiny", uneven, 4, LR, codec,
                 drop_remainder=False)
    lj, lt = r["logs_j"][0], r["logs_t"][0]
    assert lt.weights == lj.weights and min(lt.weights) < 4
    assert sum(lt.weights) == 45 and lt.steps == lj.steps
    np.testing.assert_allclose(lt.losses, lj.losses, atol=TOL, rtol=0)


@pytest.mark.parametrize("method", ["sflv3_ac", "sflv1_ac"])
def test_batch_synchronous_methods_refuse_short_batches(method):
    ja, ta = _adapters("tiny", False)
    with pytest.raises(ValueError) as ej:
        j_make_strategy(method, ja, lambda: JO.adam(LR), 5,
                        engine="stepwise", drop_remainder=False)
    with pytest.raises(ValueError) as et:
        make_strategy(method, ta, lambda: TO.adam(LR), 5, device="cpu",
                      drop_remainder=False)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("method, nls, kw, err", [
    ("centralized", False, dict(transport=True), ValueError),
    ("fl", False, dict(privacy=dict(cut_noise_std=0.5)), ValueError),
    ("sl_am", False, dict(privacy=dict(secagg=True)), ValueError),
    # privacy on SFLv2 and under NLS is ported now (M8), participation
    # (M9), observe= (M10) and shard= (M11): these three cases keep their
    # ids and check the options that still raise on those private paths
    # (the split family takes fixed-size participation only, is never
    # observed under participation, and is never placed under it: the
    # reference's ValueErrors)
    pytest.param("sflv2_ac", False, dict(
        privacy=dict(noise_multiplier=1.0, clip_norm=1.0),
        participation=dict(q=0.5)), ValueError, id="sflv2_ac-False-kw3-M8"),
    pytest.param("sflv3_ac", True, dict(privacy=dict(cut_noise_std=0.5),
                                        observe=True,
                                        participation=dict(k=2)),
                 ValueError, id="sflv3_ac-True-kw4-M8"),
    pytest.param("sflv1_ac", True, dict(
        privacy=dict(noise_multiplier=1.0, clip_norm=1.0), shard=True,
        participation=dict(k=2)), ValueError, id="sflv1_ac-True-kw5-M8"),
    ("sflv4_ac", False, {}, ValueError),
])
def test_make_strategy_refuses_what_the_grid_does_not_run(method, nls, kw,
                                                          err):
    _, ta = _adapters("tiny", nls)
    kw = dict(kw)
    if kw.get("transport"):
        kw["transport"] = Transport("int8", device="cpu")
    if "privacy" in kw:
        kw["privacy"] = PrivacyConfig(**kw["privacy"])
    if "participation" in kw:
        from repro_torch.core.participation import Participation
        kw["participation"] = Participation(n_global=5,
                                            **kw["participation"])
    with pytest.raises(err):
        make_strategy(method, ta, lambda: TO.adam(LR), 5, device="cpu",
                      **kw)
