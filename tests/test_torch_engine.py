"""The port's compiled engine (``core/strategies/engine.py``) against its
stepwise engine, on the CPU, where a program runs its step body eagerly
over the same static buffers a CUDA graph replays on the card.

Setup: ``tests/test_engine.py``'s uneven hospitals of 17, 12 and 9 train
images at batch 4 (FL steps over masked padding cells; with
``drop_remainder=False`` the short batches become pad-and-mask weights),
on the tiny DenseNet of ``tests/test_system.py`` at 16x16, and on
``DENSENET_MINI``/``UNET_MINI`` at 32x32; the split family over the int8
link.  Tolerances:
  * losses and every param of every hospital: <= 1e-5, the reference's
    own bar between its engines (``tests/test_engine.py``); the two
    engines run the same step arithmetic, so most cases read 0;
  * epsilon, the wire bytes and every noise draw: exactly equal;
  * Adam with its count on the device: bit-equal to the host-count Adam
    it replaced, over 20 steps.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch import optim as TO
from repro_torch.configs.paper_models import DENSENET_MINI, UNET_MINI
from repro_torch.core.partition import cnn_adapter
from repro_torch.core.schedule import SCHEDULES, schedule_array
from repro_torch.core.strategies import METHODS, make_strategy
from repro_torch.core.strategies import engine as ENG
from repro_torch.core.strategies.base import np_batches
from repro_torch.data.synthetic import make_cxr_clients
from repro_torch.models.cnn import DenseNetConfig, build_densenet, build_unet
from repro_torch.privacy import PrivacyConfig
from repro_torch.privacy import accountant as AC
from repro_torch.privacy import dpsgd as TD
from repro_torch.tree import (stack_trees, tree_leaves, tree_map, tree_put,
                              tree_select, tree_take)
from repro_torch.wire import Transport

torch.set_num_threads(2)

TOL = 1e-5
TINY = DenseNetConfig(growth=4, blocks=(1, 1), stem_ch=8, cut_layer=1)
DP = dict(noise_multiplier=1.1, clip_norm=1.0)
CUT = dict(cut_noise_std=0.5)


@pytest.fixture(scope="module")
def uneven():
    return {size: make_cxr_clients(seed=0, train_per_client=[17, 12, 9],
                                   val_per_client=6, test_per_client=7,
                                   image_size=size, n_clients=3)
            for size in (16, 32)}


def adapter(arch, nls=False):
    if arch == "tiny":
        return cnn_adapter(build_densenet(TINY, nls=nls))
    if arch == "densenet-mini":
        return cnn_adapter(build_densenet(DENSENET_MINI, nls=nls))
    return cnn_adapter(build_unet(UNET_MINI, nls=nls))


def train(method, engine, clients, arch="tiny", nls=False, epochs=1,
          whole=False, privacy=None, drop_remainder=True, batch=4,
          codec="int8"):
    """``epochs`` epochs from seed 0, with ``Strategy.run`` (``whole``) or
    ``run_epoch`` after ``run_epoch``; the split family over ``codec``
    (int8 unless asked)."""
    split = method not in ("centralized", "fl")
    tr = Transport(codec, device="cpu") if split else None
    st = make_strategy(method, adapter(arch, nls), lambda: TO.adam(1e-3),
                       len(clients), transport=tr, engine=engine,
                       drop_remainder=drop_remainder, device="cpu",
                       privacy=None if privacy is None
                       else PrivacyConfig(**privacy))
    state = st.setup(0)
    data = [c.train for c in clients]
    rng = np.random.default_rng(0)
    if whole:
        state, logs = st.run(state, data, rng, batch, epochs)
    else:
        logs = []
        for _ in range(epochs):
            state, log = st.run_epoch(state, data, rng, batch)
            logs.append(log)
    return dict(st=st, state=state, logs=logs, tr=tr)


def assert_engines_agree(a, b, n_clients):
    assert len(a["logs"]) == len(b["logs"])
    for la, lb in zip(a["logs"], b["logs"]):
        assert (la.steps, la.weights, la.client_steps) == (
            lb.steps, lb.weights, lb.client_steps)
        assert len(la.losses) == len(lb.losses)
        np.testing.assert_allclose(lb.losses, la.losses, atol=TOL, rtol=0)
        assert abs(la.mean_loss - lb.mean_loss) <= TOL
    for c in range(n_clients):
        pa = a["st"].params_for_eval(a["state"], c)
        pb = b["st"].params_for_eval(b["state"], c)
        for x, y in zip(tree_leaves(pa), tree_leaves(pb)):
            assert x.dtype == y.dtype == torch.float32
            np.testing.assert_allclose(y.numpy(), x.numpy(), atol=TOL,
                                       rtol=0)
    assert a["st"].privacy_report() == b["st"].privacy_report()
    if a["tr"] is not None:
        assert a["tr"].summary() == b["tr"].summary()
        assert a["tr"].epoch_log == b["tr"].epoch_log


GRID = ([(m, nls, True) for m in METHODS for nls in (False, True)]
        + [(m, nls, False) for m in METHODS
           if not m.startswith(("sflv3", "sflv1")) for nls in (False, True)])


@pytest.mark.parametrize("method, nls, drop_remainder", GRID)
def test_compiled_matches_stepwise(uneven, method, nls, drop_remainder):
    """Two epochs, one ``run_epoch`` at a time, of every method in both
    cuts; ``drop_remainder=False`` keeps the short batches (pad-and-mask
    weights in the compiled engine)."""
    clients = uneven[16]
    kw = dict(nls=nls, epochs=2, drop_remainder=drop_remainder)
    assert_engines_agree(train(method, "stepwise", clients, **kw),
                         train(method, "compiled", clients, **kw),
                         len(clients))


@pytest.mark.parametrize("method, arch, nls", [
    ("sflv3_ac", "densenet-mini", False), ("sl_am", "densenet-mini", True),
    ("fl", "densenet-mini", False), ("sflv2_ac", "unet-mini", True),
    ("sflv3_ac", "unet-mini", True), ("centralized", "unet-mini", False)])
def test_compiled_matches_stepwise_on_the_paper_models(uneven, method, arch,
                                                       nls):
    """The mini configs of the paper's models at 32x32 (the U-Net crosses
    a pytree boundary: hidden state and skips)."""
    clients = uneven[32]
    assert_engines_agree(train(method, "stepwise", clients, arch, nls),
                         train(method, "compiled", clients, arch, nls),
                         len(clients))


def _private_grid():
    """(method, nls, drop_remainder, privacy) of every private row: DP-SGD
    on every method, cut noise (alone and with DP) on the split family, in
    both cuts, and with the remainder batches kept wherever the method
    allows it.  SFLv3/v1 in the LS cut keep their earlier ids."""
    kinds = [("dp", DP), ("cut", CUT), ("dp+cut", {**DP, **CUT})]
    out = []
    for name, priv in kinds:
        for m in ("sflv3_ac", "sflv1_ac"):
            out.append(pytest.param(m, False, True, priv, id=f"{name}-{m}"))
    for m in METHODS:
        split = m not in ("centralized", "fl")
        for nls in (False, True):
            for keep in (False, True):
                if (not nls and m.startswith(("sflv3", "sflv1"))) or (
                        keep and m.startswith(("sflv3", "sflv1"))):
                    continue
                for name, priv in kinds if split else kinds[:1]:
                    out.append(pytest.param(
                        m, nls, not keep, priv,
                        id=f"{name}-{m}-{'NLS' if nls else 'LS'}"
                           + ("-keep" if keep else "")))
    return out


def _steps(method, drop_remainder, epochs=2, sizes=(17, 12, 9), batch=4):
    """Each hospital's accounted steps over ``epochs`` epochs."""
    nb = [n // batch + (0 if drop_remainder or not n % batch else 1)
          for n in sizes]
    if method == "centralized":
        pooled = sum(sizes)
        return [epochs * (pooled // batch + (
            0 if drop_remainder or not pooled % batch else 1))] * len(sizes)
    if method.startswith(("sflv3", "sflv1")):
        return [epochs * max(nb)] * len(sizes)
    return [epochs * n for n in nb]


@pytest.mark.parametrize("method, nls, drop_remainder, privacy",
                         _private_grid())
def test_private_steps_draw_the_same_noise(uneven, monkeypatch, method, nls,
                                           drop_remainder, privacy):
    """DP-SGD and cut-layer noise: the compiled engine fills its static
    noise buffers from the streams the stepwise step draws from (seeded by
    the step indices it reserved up front and the hospital of each step),
    so every draw, every param and epsilon agree; over two epochs with
    ``Strategy.run``.  The cut noise is drawn at the padded batch length,
    so a kept remainder batch (stepwise: short; compiled: padded and
    weighted, K4's row weight 0 on the padding) takes the same draws on
    its real rows.  The rows that keep their remainder batches run over
    the identity link, as the reference's own parity suite does
    (``tests/test_engine.py``): the weighted loss of a padded batch sums
    in another order than the short batch's mean (1e-7), and over the
    int8 link such a difference can put one cut element on the
    neighbouring level, which Adam carries past 1e-5 (sl_am, LS, cut
    noise: 2.95e-5 in one loss of the second epoch)."""
    draws = {}
    real = TD._leaf_noise
    codec = "int8" if drop_remainder else "identity"
    for engine in ("stepwise", "compiled"):
        got = draws[engine] = []

        def record(l, gen, std):
            z = real(l, gen, std)
            got.append(z.clone())
            return z
        monkeypatch.setattr(TD, "_leaf_noise", record)
        draws[engine + "_run"] = train(method, engine, uneven[16], nls=nls,
                                       epochs=2, whole=True, privacy=privacy,
                                       drop_remainder=drop_remainder,
                                       codec=codec)
    assert len(draws["stepwise"]) == len(draws["compiled"]) > 0
    assert all(torch.equal(a, b) for a, b in zip(draws["stepwise"],
                                                  draws["compiled"]))
    a, b = draws["stepwise_run"], draws["compiled_run"]
    assert_engines_agree(a, b, 3)
    report = b["st"].privacy_report()
    if "noise_multiplier" in privacy:
        assert [r["steps"] for r in report] == _steps(method,
                                                      drop_remainder)
        assert all(0 < r["epsilon"] < math.inf for r in report)
    else:
        assert report == []


@pytest.mark.parametrize("method", ["centralized", "fl", "sl_am",
                                    "sflv2_ac", "sflv3_ac", "sflv1_ac"])
def test_three_epoch_run_builds_one_program(uneven, method):
    """``Strategy.run(3)`` packs the run up front and steps it with one
    program; it equals three stepwise epochs, and a second run and a
    later ``run_epoch`` of the same layout reuse that program."""
    clients = uneven[16]
    a = train(method, "stepwise", clients, epochs=3, whole=True)
    b = train(method, "compiled", clients, epochs=3, whole=True)
    assert_engines_agree(a, b, 3)
    st = b["st"]
    assert len(st._programs) == 1
    prog = next(iter(st._programs.values()))
    assert set(prog.bodies) == {
        "fl": {"step", "round"}, "sflv2_ac": {"step", "round"},
        "sflv3_ac": {"begin", "step", "round"},
        "sflv1_ac": {"begin", "step", "round"}}.get(method, {"step"})
    state, logs = st.run(st.setup(1), [c.train for c in clients],
                         np.random.default_rng(1), 4, 2)
    st.run_epoch(state, [c.train for c in clients],
                 np.random.default_rng(2), 4)
    assert len(logs) == 2 and list(st._programs.values()) == [prog]


def test_fl_steps_over_masked_cells(uneven):
    """FL's grid holds a padding cell for every batch a hospital lacks
    (17/12/9 images at batch 4: 4, 3 and 2 batches, 12 cells); the masked
    cells change nothing, so the epoch equals the stepwise one.  The
    table's last column is the slot of the stacked locals, the hospital
    itself without participation."""
    clients = uneven[16]
    b = train("fl", "compiled", clients)
    prog = next(iter(b["st"]._programs.values()))
    rows = prog.table.numpy()
    assert rows.shape == (12, 5)
    assert rows[:, 4].tolist() == rows[:, 1].tolist() == [0] * 4 + [1] * 4 \
        + [2] * 4
    assert rows[:, 2].tolist() == [1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 0, 0]
    assert rows[:, 3].tolist() == [1, 0, 0, 0] * 3
    assert b["logs"][0].client_steps == [4, 3, 2]


def test_empty_run_falls_back_to_the_epoch_loop(uneven):
    """No hospital has a batch of 32: the compiled run trains nothing and
    builds no program, like the stepwise loop."""
    clients = uneven[16]
    for method in ("fl", "sl_am", "centralized"):
        b = train(method, "compiled", clients, whole=True, batch=64,
                  epochs=2)
        assert [l.steps for l in b["logs"]] == [0, 0]
        assert not b["st"]._programs
    assert train("fl", "compiled", clients, epochs=0,
                 whole=True)["logs"] == []


def test_pack_epoch_matches_np_batches():
    data = [{"x": np.arange(10, dtype=np.float32)[:, None],
             "label": np.arange(10)},
            {"x": np.arange(5, dtype=np.float32)[:, None],
             "label": np.arange(5)}]
    packed = ENG.pack_epoch(data, 2, np.random.default_rng(3))
    assert packed.mask.shape == (2, 5) and packed.n_batches == [5, 2]
    assert packed.mask[1].tolist() == [True, True, False, False, False]
    rng = np.random.default_rng(3)
    stepwise = [np_batches(d, 2, rng) for d in data]
    for c, bs in enumerate(stepwise):
        for j, b in enumerate(bs):
            np.testing.assert_array_equal(packed.batches["label"][c, j],
                                          b["label"])
    kept = ENG.pack_epoch(data, 3, np.random.default_rng(0),
                          drop_remainder=False)
    assert kept.n_batches == [4, 2]
    assert kept.ex_weights[0, 3].tolist() == [1.0, 0.0, 0.0]
    assert kept.step_examples[0] == [3, 3, 3, 1]
    # a run consumes the rng as a loop of epochs does
    batches, first = ENG.pack_run(data, 2, np.random.default_rng(5), 3)
    rng = np.random.default_rng(5)
    for e in range(3):
        p = ENG.pack_epoch(data, 2, rng)
        np.testing.assert_array_equal(batches["x"][e], p.batches["x"])
    assert first.n_batches == [5, 2]
    assert ENG.empty_run(data, 11) and not ENG.empty_run(data, 10)
    assert not ENG.empty_run(data, 11, drop_remainder=False)


def test_schedule_log_helpers():
    packed = ENG.pack_epoch([{"label": np.arange(5)},
                             {"label": np.arange(3)}], 2,
                            np.random.default_rng(0), drop_remainder=False)
    sched = schedule_array("am", packed.n_batches)
    assert [tuple(r) for r in sched] == SCHEDULES["am"](packed.n_batches)
    flat, w = ENG.scheduled_log(np.arange(len(sched)), sched, packed)
    assert w == [2, 2, 2, 1, 1] and flat == [0.0, 1.0, 2.0, 3.0, 4.0]
    flat, w = ENG.client_major_log(np.arange(6).reshape(2, 3), packed)
    assert flat == [0.0, 1.0, 2.0, 3.0, 4.0] and w == [2, 2, 1, 2, 1]


def _host_count_adam(lr, b1=0.9, b2=0.999, eps=1e-8):
    """The port's Adam before its count moved to the device: a Python int
    count and f32 bias corrections built from host scalars."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32)

    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"step": 0, "mu": tree_map(z, params),
                "nu": tree_map(z, params)}

    def update(grads, state):
        step = state["step"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
            g.float()), state["nu"], grads)
        n = f32(float(step))
        bc1 = 1 - torch.pow(f32(b1), n)
        bc2 = 1 - torch.pow(f32(b2), n)
        return tree_map(lambda m, v: -lr * (m / bc1) / (
            torch.sqrt(v / bc2) + eps), mu, nu), {"step": step, "mu": mu,
                                                  "nu": nu}
    return init, update


def test_adam_device_count_is_bit_equal_to_the_host_count():
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn((3, 4), generator=gen),
              "b": {"c": torch.randn((5,), generator=gen)}}
    grads = [tree_map(lambda p, i=i: torch.randn(p.shape, generator=gen)
                      * (i + 1), params) for i in range(20)]
    opt = TO.adam(1e-2)
    init, update = _host_count_adam(1e-2)
    pd, sd = params, opt.init(params)
    ph, sh = params, init(params)
    assert sd["step"].dtype == torch.int64 and sd["step"].dim() == 0
    for g in grads:
        ud, sd = opt.update(g, sd)
        uh, sh = update(g, sh)
        pd, ph = TO.apply_updates(pd, ud), TO.apply_updates(ph, uh)
        for x, y in zip(tree_leaves([ud, sd["mu"], sd["nu"], pd]),
                        tree_leaves([uh, sh["mu"], sh["nu"], ph])):
            assert torch.equal(x, y)
    assert int(sd["step"]) == sh["step"] == 20


def test_a_masked_step_leaves_adam_alone():
    """``tree_select`` on the padding flag: a masked step keeps params,
    moments and Adam's count; a valid one takes the update."""
    opt = TO.adam(1e-2)
    params = {"w": torch.ones((4,))}
    state = opt.init(params)
    grads = {"w": torch.full((4,), 0.5)}
    upd, new = opt.update(grads, state)
    stepped = TO.apply_updates(params, upd)
    off, on = torch.tensor(False), torch.tensor(True)
    kept_p, kept_s = (tree_select(off, stepped, params),
                      tree_select(off, new, state))
    assert torch.equal(kept_p["w"], params["w"])
    assert int(kept_s["step"]) == 0 and not kept_s["mu"]["w"].any()
    took = tree_select(on, new, state)
    assert int(took["step"]) == 1
    assert torch.equal(took["mu"]["w"], new["mu"]["w"])


def test_stacked_tree_helpers_index_by_device_tensor():
    trees = [{"a": torch.full((2,), float(i)), "b": [torch.tensor(i)]}
             for i in range(3)]
    st = stack_trees(trees)
    assert st["a"].shape == (3, 2) and st["b"][0].shape == (3,)
    i = torch.tensor([1])
    one = tree_take(st, i)
    assert torch.equal(one["a"], trees[1]["a"])
    one["a"].add_(10)                       # a copy, not a view
    assert torch.equal(st["a"][1], trees[1]["a"])
    tree_put(st, i, {"a": torch.full((2,), 7.0), "b": [torch.tensor(9)]})
    assert st["a"][1].tolist() == [7.0, 7.0] and int(st["b"][0][1]) == 9
    assert st["a"][0].tolist() == [0.0, 0.0]


@pytest.mark.parametrize("split", [(1, 1, 1, 1, 1, 1, 1), (3, 4), (7,),
                                   (2, 5)])
def test_accountant_composes_exactly_additively(split):
    """``step(q, a); step(q, b)`` is ``step(q, a + b)`` to the bit (the
    reference's float ledger is not: ``tests/test_property.py::
    test_epsilon_round_composition_additive``), which is what lets the
    compiled engine account an epoch in one call."""
    one = AC.RDPAccountant(1.1)
    for n in split:
        one.step(0.25, n)
    whole = AC.RDPAccountant(1.1)
    whole.step(0.25, sum(split))
    assert one.summary() == whole.summary()
    assert one.rdp() == whole.rdp()


def test_dropping_the_strategy_frees_its_program(uneven):
    """A program holds no reference back to its strategy, so the last
    reference to the strategy frees the program (and on the card its
    graphs' memory pools) without waiting for the cycle collector."""
    import gc
    import weakref
    methods = ("fl", "sl_am", "sflv3_ac")
    for method in methods:          # PyTorch's one-time meta-op set-up
        train(method, "compiled", uneven[16])
    gc.collect()
    gc.disable()
    try:
        for method in methods:
            b = train(method, "compiled", uneven[16])
            ref = weakref.ref(next(iter(b["st"]._programs.values())))
            del b
            assert ref() is None, method
    finally:
        gc.enable()


def test_graph_tables_live_outside_the_capture(monkeypatch):
    """The K5/K6 leaf tables of a captured step (``build.GraphTables``):
    the warm-up records their sizes, they are reserved before the capture
    (outside the graph's memory pool), the capture takes them in order and
    they are filled after it; a capture without a warm-up's reservation
    raises.  (Simulated on the CPU: here nothing captures for real.)"""
    from repro_torch.kernels import build as B
    capturing = [False]
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda t: t)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    cpu = torch.device("cpu")
    tables = B.GraphTables()
    with tables:                                    # the warm-up
        warm = [B.upload_int64([7, 8, 9], cpu), B.upload_int64([1], cpu)]
    assert tables.sizes == [3, 1] and warm[0].tolist() == [7, 8, 9]
    tables.reserve(cpu)
    reserved = list(tables.tables)
    capturing[0] = True
    with tables:                                    # the capture
        got = [B.upload_int64([4, 5, 6], cpu), B.upload_int64([2], cpu)]
    assert got[0] is reserved[0] and got[1] is reserved[1]
    tables.fill()
    assert got[0].tolist() == [4, 5, 6] and got[1].tolist() == [2]
    with pytest.raises(RuntimeError, match="GraphTables"):
        B.upload_int64([1, 2], cpu)
    with pytest.raises(RuntimeError, match="warm-up"), B.GraphTables():
        B.upload_int64([1, 2], cpu)
