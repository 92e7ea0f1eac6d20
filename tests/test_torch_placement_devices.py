"""Placed runs over virtual devices (``make_strategy(..., shard=True,
devices=[cpu] * 4)``) against ``shard=False``, within the port, on the
CPU: the tiny DenseNet at 16x16, 5 hospitals of 13, 9, 11, 8 and 10
images (uneven, so FedAvg's weights and the masked steps matter), batch 4,
Adam at 1e-3, 2 epochs of one ``run``.  Four devices pad the 5 hospitals
to 8: 3 phantoms, one chunk of phantoms only.

  * every method the reference places (FL privately, SL-AC/AM, SFLv2,
    SFLv3 over the fused int8 link with cut noise, SFLv1 privately; LS and
    NLS): params, losses and ``scores_all`` bit-equal (the placed run
    computes what the unplaced one does, in the same order: the reference
    asks for 1e-5), step counts and loss weights equal, epsilon and wire
    bytes exactly equal;
  * the chunk programs: one per chunk (4, repeated devices kept apart),
    each holding its own hospitals, its buffers on its chunk's device;
  * ``observe=True`` (``tests/test_obs.py``'s placed case): every round's
    metrics of the same keys and shapes, phantom columns sliced off,
    bit-equal;
  * one device: ``shard=True`` is the identity, bit for bit; with
    ``participation=`` it raises the reference's ``ValueError``.
"""

import numpy as np
import pytest
import torch

from repro_torch import optim as TO
from repro_torch.core.participation import Participation
from repro_torch.core.partition import cnn_adapter
from repro_torch.core.strategies import make_strategy
from repro_torch.data.synthetic import make_cxr_clients
from repro_torch.models.cnn import DenseNetConfig, build_densenet
from repro_torch.privacy import PrivacyConfig
from repro_torch.tree import tree_leaves
from repro_torch.wire import Transport

torch.set_num_threads(2)

SIZES, BATCH, LR, EPOCHS = [13, 9, 11, 8, 10], 4, 1e-3, 2
TINY = dict(growth=4, blocks=(1, 1), stem_ch=8, cut_layer=1)
CPU4 = [torch.device("cpu")] * 4
DP = dict(noise_multiplier=1.1, clip_norm=1.0)
CUT = dict(cut_noise_std=0.1)
#: (method, nls, codec, privacy)
ROWS = [("fl", False, None, DP),
        ("sl_am", False, "identity", None),
        ("sl_ac", True, "int8", None),
        ("sflv2_ac", False, "int8", None),
        ("sflv3_ac", False, "int8", CUT),
        ("sflv3_am", True, "int8", CUT),
        ("sflv3_ac", True, "identity", dict(DP, **CUT)),
        ("sflv1_ac", False, "identity", DP),
        ("sflv1_ac", True, "int8", None)]


@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, n_clients=5, train_per_client=SIZES,
                            val_per_client=4, test_per_client=6,
                            image_size=16)


def _run(method, nls, codec, privacy, clients, shard, devices=CPU4,
         observe=None):
    ad = cnn_adapter(build_densenet(DenseNetConfig(**TINY), nls=nls))
    tr = None if codec is None else Transport(codec, device="cpu")
    st = make_strategy(method, ad, lambda: TO.adam(LR), len(clients),
                       transport=tr, privacy=None if privacy is None
                       else PrivacyConfig(**privacy), device="cpu",
                       shard=shard, devices=devices, observe=observe)
    state, logs = st.run(st.setup(0), [c.train for c in clients],
                         np.random.default_rng(0), BATCH, EPOCHS)
    return dict(st=st, state=state, logs=logs, tr=tr, params=[
        [l.clone() for l in tree_leaves(st.params_for_eval(state, i))]
        for i in range(len(clients))],
        scores=st.scores_all(state, [c.test for c in clients], BATCH))


@pytest.mark.parametrize(
    "method, nls, codec, privacy", ROWS,
    ids=[f"{r[0]}-{'nls' if r[1] else 'ls'}-{r[2]}-"
         f"{'+'.join(sorted(r[3])) if r[3] else 'plain'}" for r in ROWS])
def test_placed_run_matches_unplaced(method, nls, codec, privacy, clients):
    a = _run(method, nls, codec, privacy, clients, False)
    b = _run(method, nls, codec, privacy, clients, True)
    place = b["st"].placement
    assert place.enabled and (place.c_pad, place.n_pad) == (8, 3)
    assert not a["st"].placement.enabled
    for la, lb in zip(a["logs"], b["logs"]):
        assert (lb.steps, lb.weights, lb.client_steps) == (
            la.steps, la.weights, la.client_steps)
        assert lb.losses == la.losses
    for pa, pb in zip(a["params"], b["params"]):
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    for x, y in zip(a["scores"], b["scores"]):
        np.testing.assert_array_equal(y, x)
    assert b["st"].privacy_report() == a["st"].privacy_report()
    if codec is not None:
        assert b["tr"].bytes_on_wire > 0
        assert (b["tr"].steps, b["tr"].bytes_on_wire) == (
            a["tr"].steps, a["tr"].bytes_on_wire)
    # one program per chunk, each holding its own hospitals on its device
    # (the non-private SFLv3/v1 server: one more program, on the first)
    progs = b["st"]._programs
    chunks = {k: p for k, p in progs.items() if k[0][0] != "sync_server"}
    assert sorted(key[0][1] for key in chunks) == [0, 1, 2, 3]
    assert len(progs) - len(chunks) == int(
        method.startswith(("sflv3", "sflv1")) and privacy != DP
        and "noise_multiplier" not in (privacy or {}))
    nb = max(n // BATCH for n in SIZES)
    for key, prog in progs.items():
        dev = place.devices[key[0][1] if key in chunks else 0]
        assert prog.device == dev
        assert all(t.device == dev for t in [*prog.batches.values(),
                                             prog.losses, prog.t])
        # a chunk holds its 2 hospitals' [2, NB] batch grid, flattened
        # (the server, the 5 real ones')
        assert next(iter(prog.batches.values())).shape[0] == (
            2 if key in chunks else len(SIZES)) * nb
    assert b["st"]._pools == a["st"]._pools == {}       # no CUDA graph


@pytest.mark.parametrize("method", ["fl", "sflv3_ac"])
def test_placed_run_observed(method, clients):
    codec = None if method == "fl" else "int8"
    a = _run(method, False, codec, None, clients, False, observe=True)
    b = _run(method, False, codec, None, clients, True, observe=True)
    ra, rb = a["st"].last_run_telemetry, b["st"].last_run_telemetry
    assert len(ra.rounds) == len(rb.rounds) == EPOCHS
    for x, y in zip(ra.rounds, rb.rounds):
        assert x.metrics.keys() == y.metrics.keys()
        for k in x.metrics:
            mx, my = np.asarray(x.metrics[k]), np.asarray(y.metrics[k])
            assert mx.shape == my.shape and mx.shape[-1] == len(SIZES)
            np.testing.assert_array_equal(my, mx)
    for pa, pb in zip(a["params"], b["params"]):
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))


@pytest.mark.parametrize("method", ["fl", "sflv3_ac"])
def test_one_device_is_the_identity(method, clients):
    a = _run(method, False, None, None, clients, False, devices=None)
    b = _run(method, False, None, None, clients, True, devices=None)
    assert not b["st"].placement.enabled and not b["st"].placement.padded
    for la, lb in zip(a["logs"], b["logs"]):
        assert la.losses == lb.losses
    for pa, pb in zip(a["params"], b["params"]):
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))


def test_shard_with_participation_raises():
    ad = cnn_adapter(build_densenet(DenseNetConfig(**TINY)))
    with pytest.raises(ValueError, match="shard= is not supported"):
        make_strategy("fl", ad, lambda: TO.adam(LR), 5, device="cpu",
                      shard=True, devices=CPU4,
                      participation=Participation(n_global=5, k=2))
