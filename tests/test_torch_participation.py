"""Per-round participation (``core.participation``) in the port against
``repro``, on the CPU, at the sizes of ``tests/test_participation.py``:
the tiny DenseNet at 16x16, 3 hospitals of 17, 12 and 9 images, batch 4,
2 rounds, both packages' compiled engines from the same converted weights
and the same numpy batch order.

  * ``round_ids`` and ``pack_participation_run``'s arrays equal to the
    reference's (and, at k = N, to ``pack_run``'s);
  * participating FL (fixed, Poisson and schedule), SL-AC, SFLv2 and
    SFLv3/v1 over an identity link against the reference's compiled runs
    (fixed FL, SL-AC and SFLv3 under DP-SGD at noise 0, so the clip runs,
    per slot on SFLv3, and nothing random does; Poisson FL and SFLv2 with
    their remainder batches kept; SL with a round padded by an invalid
    row, SFLv3/v1 with and without masked steps): step counts, loss
    weights and client steps equal, losses within 1e-4, every param within
    1e-6 (1% of lr);
  * epsilon per hospital exactly the reference's after one round under
    ``noise_multiplier=1.1`` (at most 4 steps per rate: the reference adds
    each step into a float ledger, the port forms count x per-step RDP,
    and over so few steps they agree to the bit), and strictly below the
    same run's at k = N.  The reference composes epsilon on the host from
    its packing alone, so its private training program is replaced by one
    that returns its inputs (``_untrained``): its JAX compile of the
    per-example DP step would take most of this file's time;
  * the transport's bytes, steps and ``client_set`` per round equal to the
    reference's;
  * within the port: k = N trains exactly as ``participation=None``
    (losses and params bit-equal), a hospital's round does not depend on
    who else was sampled, phantom slots change nothing, an empty Poisson
    round keeps the params, ``run_epoch`` trains every hospital (as the
    reference's does), SFLv3's client Adam keeps one count, and a
    participating run builds one program, captured once per body;
  * the reference's ``ValueError``s on the same combinations.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.core import participation as JP
from repro.core.strategies import engine as JENG
from repro.core.strategies import make_strategy as j_make_strategy
from repro.data.synthetic import make_cxr_clients
from repro.privacy import PrivacyConfig as JPrivacy
from repro.wire import Transport as JTransport
from repro_torch import optim as TO
from repro_torch.core.participation import Participation, as_participation
from repro_torch.core.strategies import engine as ENG
from repro_torch.core.strategies import make_strategy
from repro_torch.privacy import PrivacyConfig
from repro_torch.tree import tree_leaves
from repro_torch.wire import Transport
from torch_grid_pair import adapters, flat, param_pairs, port_state

torch.set_num_threads(2)

BATCH, LR, EPOCHS, TOL = 4, 1e-4, 2, 1e-4
PARAM_TOL = 0.01 * LR
SIZES = [17, 12, 9]
CLIP = dict(noise_multiplier=0.0, clip_norm=1.0)
DP = dict(noise_multiplier=1.1, clip_norm=1.0)
FIXED = dict(n_global=3, k=2, seed=0)
# seed 0 samples hospitals (1, 2) twice: SL's rounds run 5 steps each
# (no padded row) and SFLv3's 3 of its 4 (masked); seed 4 samples (1, 2)
# then (0, 2), so SL's first round is padded by one invalid row; seed 1
# samples (0, 1) twice, so SFLv3 runs all 4 steps (no mask)
SPECS = {"fixed": FIXED, "uneven": dict(n_global=3, k=2, seed=4),
         "full_depth": dict(n_global=3, k=2, seed=1),
         "poisson": dict(n_global=3, q=0.6, seed=1),
         "schedule": dict(n_global=3, schedule=((0, 2), (1,)))}


@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, train_per_client=SIZES,
                            val_per_client=6, test_per_client=7,
                            image_size=16, n_clients=3)


def _untrained(method):
    """A stand-in for the reference's whole-run participating program:
    the state comes back unchanged, with zero losses of the program's
    shape (FL ``[E, S, NB]``, SL ``[E, steps]``, SFLv3 ``[E, NB, S]``)."""
    if method == "fl":
        return lambda gp, b, *a: (gp, np.zeros(b["label"].shape[:3]))
    if method.startswith(("sflv3", "sflv1")):
        return lambda sc, sp, co, so, b, b_idx, *a: (
            sc, sp, co, so, np.zeros(b_idx.shape))
    return lambda sc, sp, co, so, b, w, sched, *a: (
        sc, sp, co, so, np.zeros(sched.shape[:2]))


def _pair(clients, method, spec, privacy=None, codec="identity",
          epochs=EPOCHS, train_reference=True, **kw):
    """``epochs`` participating rounds of one method in both packages (the
    reference's compiled ``run`` and the port's) from the reference's
    ``setup(key(0))``; ``spec`` the ``Participation`` keywords, ``kw``
    more keywords of both ``make_strategy``s; ``train_reference=False``
    replaces the reference's program by ``_untrained``."""
    split = method != "fl"
    ja, ta = adapters("tiny", False)
    tj = JTransport(codec) if split else None
    tt = Transport(codec, device="cpu") if split else None
    sj = j_make_strategy(method, ja, lambda: JO.adam(LR), 3, transport=tj,
                         privacy=privacy and JPrivacy(**privacy),
                         participation=JP.Participation(**spec), **kw)
    st = make_strategy(method, ta, lambda: TO.adam(LR), 3, transport=tt,
                       privacy=privacy and PrivacyConfig(**privacy),
                       participation=Participation(**spec), device="cpu",
                       **kw)
    state_j = sj.setup(jax.random.key(0))
    state_t = port_state(method, jax.tree.map(np.asarray, state_j))
    if not train_reference:
        name = ("_run_part_c" if method == "fl" or method.startswith("sl")
                else "_run3_part_c")
        setattr(sj, name, _untrained(method))
    data = [c.train for c in clients]
    state_j, logs_j = sj.run(state_j, data, np.random.default_rng(1), BATCH,
                             epochs)
    state_t, logs_t = st.run(state_t, data, np.random.default_rng(1), BATCH,
                             epochs)
    return dict(sj=sj, st=st, tj=tj, tt=tt, logs_j=logs_j, logs_t=logs_t,
                state_j=jax.tree.map(np.asarray, state_j), state_t=state_t)


def _port_run(clients, method, part, privacy=None, epochs=EPOCHS, seed=0,
              transport=None):
    ta = adapters("tiny", False)[1]
    st = make_strategy(method, ta, lambda: TO.adam(LR), 3,
                       privacy=privacy and PrivacyConfig(**privacy),
                       transport=transport, participation=part,
                       device="cpu")
    state = st.setup(seed)
    state, logs = st.run(state, [c.train for c in clients],
                         np.random.default_rng(1), BATCH, epochs)
    return st, state, logs


def _params(st, state):
    return [tree_leaves(st.params_for_eval(state, c)) for c in range(3)]


# ---------------------------------------------------------------------------
# the spec and the packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    dict(n_global=10, k=4, seed=0), dict(n_global=50, k=7, seed=3),
    dict(n_global=10, q=0.3, seed=2), dict(n_global=50, q=0.9, slots=5,
                                           seed=1),
    dict(n_global=4, schedule=((2, 0), (1,), (3, 1, 0)))])
def test_round_ids_are_the_references(spec):
    pj, pt = JP.Participation(**spec), Participation(**spec)
    assert (pt.kind, pt.n_slots, pt.rate) == (pj.kind, pj.n_slots, pj.rate)
    for r in range(3):
        np.testing.assert_array_equal(pt.round_ids(r), pj.round_ids(r))
        assert pt.round_ids(r).dtype == pj.round_ids(r).dtype


def test_spec_validation_is_the_references():
    for kw in [dict(n_global=5), dict(n_global=5, k=2, q=0.5),
               dict(n_global=5, k=0), dict(n_global=5, q=1.5),
               dict(n_global=3, schedule=((0, 5),)),
               dict(n_global=3, schedule=((1, 1),)),
               dict(n_global=5, k=2, slots=0)]:
        with pytest.raises(ValueError) as ej:
            JP.Participation(**kw)
        with pytest.raises(ValueError) as et:
            Participation(**kw)
        assert str(et.value) == str(ej.value)
    with pytest.raises(TypeError):
        as_participation("k=2")
    assert as_participation(None) is None


PACKED = [(dict(n_global=3, k=2, seed=5), True),
          (dict(n_global=3, q=0.6, seed=1), False),
          (dict(n_global=3, q=0.9, slots=2, seed=3), True),
          (dict(n_global=3, schedule=((0, 2), (1,), ())), False)]


@pytest.mark.parametrize("spec, drop", PACKED)
def test_pack_participation_run_is_the_references(clients, spec, drop):
    data = [c.train for c in clients]
    bj, pj = JENG.pack_participation_run(
        data, BATCH, np.random.default_rng(4), 3, JP.Participation(**spec),
        drop)
    bt, pt = ENG.pack_participation_run(
        data, BATCH, np.random.default_rng(4), 3, Participation(**spec),
        drop)
    for f in ("mask", "ex_weights", "agg_w", "slot_gid", "part_mask",
              "staleness"):
        a, b = getattr(pj, f), getattr(pt, f)
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert (pt.n_batches, pt.n_samples, pt.step_examples, pt.batch_size) == (
        pj.n_batches, pj.n_samples, pj.step_examples, pj.batch_size)
    assert list(bt) == list(bj)
    for k in bj:
        np.testing.assert_array_equal(bt[k], bj[k])


def test_k_equals_n_packs_pack_run(clients):
    data = [c.train for c in clients]
    b0, p0 = ENG.pack_run(data, BATCH, np.random.default_rng(2), 2, False)
    b1, p1 = ENG.pack_participation_run(
        data, BATCH, np.random.default_rng(2), 2,
        Participation(n_global=3, k=3), False)
    for k in b0:
        np.testing.assert_array_equal(b1[k], b0[k])
    np.testing.assert_array_equal(p1.mask, np.stack([p0.mask] * 2))
    np.testing.assert_array_equal(p1.ex_weights,
                                  np.stack([p0.ex_weights] * 2))


# ---------------------------------------------------------------------------
# participating runs against the reference's compiled runs
# ---------------------------------------------------------------------------

# (method, spec, privacy, drop_remainder): the Poisson FL and the SFLv2
# rows keep their remainder batches, whose 0/1 example weights change
# with the round's cohort; CLIP runs the DP-SGD clip without noise
ROWS = [("fl", "fixed", CLIP, True), ("fl", "poisson", None, False),
        ("fl", "schedule", None, True), ("sl_ac", "fixed", CLIP, True),
        ("sflv2_ac", "uneven", None, False),
        ("sflv3_ac", "full_depth", CLIP, True),
        ("sflv1_ac", "fixed", None, True)]


@pytest.mark.parametrize("method, kind, privacy, drop", ROWS,
                         ids=[f"{m}-{k}" for m, k, _, _ in ROWS])
def test_participating_run_matches_the_reference(clients, method, kind,
                                                 privacy, drop):
    r = _pair(clients, method, SPECS[kind], privacy, drop_remainder=drop)
    for lj, lt in zip(r["logs_j"], r["logs_t"], strict=True):
        assert (lt.steps, lt.weights, lt.client_steps) == (
            lj.steps, lj.weights, lj.client_steps)
        np.testing.assert_allclose(lt.losses, lj.losses, atol=TOL, rtol=0)
    for tj, tt in param_pairs(method, r["state_j"], r["state_t"]):
        fj, ft = flat(tj), flat(tt)
        assert list(fj) == list(ft)
        for k in fj:
            np.testing.assert_allclose(ft[k], fj[k], atol=PARAM_TOL, rtol=0,
                                       err_msg=str(k))
    if r["tj"] is not None:
        assert r["tt"].summary() == r["tj"].summary()
        for ej, et in zip(r["tj"].epoch_log, r["tt"].epoch_log, strict=True):
            assert et.client_set == ej.client_set
            assert et.tr_counts == ej.tr_counts and et.legs == ej.legs


@pytest.mark.parametrize("method, kind", [
    ("fl", "fixed"), ("fl", "poisson"), ("fl", "schedule"),
    ("sl_ac", "fixed"), ("sflv3_ac", "fixed")])
def test_epsilon_is_the_references(clients, method, kind):
    r = _pair(clients, method, SPECS[kind], DP, epochs=1,
              train_reference=False)
    rj, rt = r["sj"].privacy_report(), r["st"].privacy_report()
    assert [x["steps"] for x in rt] == [x["steps"] for x in rj]
    assert max(x["steps"] for x in rt) <= 4
    assert [x["epsilon"] for x in rt] == [x["epsilon"] for x in rj]
    if kind != "schedule":
        full = _port_run(clients, method, Participation(n_global=3, k=3),
                         DP, epochs=1)[0].privacy_report()
        assert all(a["epsilon"] < b["epsilon"] for a, b in zip(rt, full))


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["fl", "sl_ac", "sl_am", "sflv2_ac",
                                    "sflv3_ac", "sflv1_ac"])
def test_k_equals_n_is_no_participation(clients, method):
    privacy = CLIP if method in ("fl", "sflv3_ac") else None
    a = _port_run(clients, method, None, privacy)
    b = _port_run(clients, method, Participation(n_global=3, k=3), privacy)
    assert [l.losses for l in a[2]] == [l.losses for l in b[2]]
    assert [l.client_steps for l in a[2]] == [l.client_steps for l in b[2]]
    for pa, pb in zip(_params(a[0], a[1]), _params(b[0], b[1])):
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))


def test_a_round_does_not_depend_on_its_cohort(clients):
    """Hospital 0's round is the same whether its partner is hospital 1
    or 2: its batches and noise depend on (round, hospital) only."""
    la = _port_run(clients, "fl", Participation(n_global=3,
                                                schedule=((0, 1),)), DP,
                   epochs=1)[2]
    lb = _port_run(clients, "fl", Participation(n_global=3,
                                                schedule=((0, 2),)), DP,
                   epochs=1)[2]
    nb0 = SIZES[0] // BATCH
    assert la[0].losses[:nb0] == lb[0].losses[:nb0]


@pytest.mark.parametrize("method", ["fl", "sl_ac", "sflv3_ac"])
def test_unsampled_hospitals_keep_their_params(clients, method):
    """The split family's hospitals outside a round leave it untouched;
    FL's phantom slots (more slots than the cohort) change nothing."""
    if method == "fl":
        sched = ((0, 1), (1, 2))
        a = _port_run(clients, method, Participation(
            n_global=3, schedule=sched, slots=2))
        b = _port_run(clients, method, Participation(
            n_global=3, schedule=sched, slots=3))
        assert all(torch.equal(x, y) for x, y in zip(
            _params(a[0], a[1])[0], _params(b[0], b[1])[0]))
        return
    st, state, _ = _port_run(clients, method, None, epochs=0)
    before = [[x.clone() for x in tree_leaves(c)] for c in state["clients"]]
    st2, state2, logs = _port_run(clients, method, Participation(**FIXED))
    assert [l.client_steps[0] for l in logs] == [0, 0]   # never sampled
    for c in range(3):
        same = all(torch.equal(x, y) for x, y in zip(
            before[c], tree_leaves(state2["clients"][c])))
        assert same == (c == 0)


def test_empty_poisson_round_keeps_the_params(clients):
    seed = next(s for s in range(1000)
                if len(Participation(n_global=3, q=0.05,
                                     seed=s).round_ids(0)) == 0)
    st, state, _ = _port_run(clients, "fl", None, epochs=0)
    before = [x.clone() for x in tree_leaves(state["params"])]
    st, state, logs = _port_run(
        clients, "fl", Participation(n_global=3, q=0.05, seed=seed),
        epochs=1)
    assert logs[0].client_steps == [0, 0, 0] and logs[0].losses == []
    assert all(torch.equal(x, y) for x, y in zip(
        before, tree_leaves(state["params"])))


def test_run_epoch_trains_every_hospital(clients):
    """As in the reference, participation applies to ``run`` only."""
    ta = adapters("tiny", False)[1]
    st = make_strategy("sl_ac", ta, lambda: TO.adam(LR), 3,
                       participation=Participation(n_global=3, k=1),
                       device="cpu")
    state, log = st.run_epoch(st.setup(0), [c.train for c in clients],
                              np.random.default_rng(1), BATCH)
    assert log.client_steps == [s // BATCH for s in SIZES]


def test_sflv3_client_adam_keeps_one_count(clients):
    st, state, logs = _port_run(clients, "sflv3_ac",
                                Participation(n_global=3, k=2))
    steps = sum(l.steps for l in logs)
    assert [int(co["step"]) for co in state["c_opts"]] == [steps] * 3


@pytest.mark.parametrize("method, kind, short", [
    ("fl", "fixed", None), ("sl_am", "fixed", False),
    ("sflv2_ac", "uneven", True), ("sflv3_ac", "fixed", True),
    ("sflv1_ac", "full_depth", False)])
def test_one_program_over_the_run(clients, method, kind, short):
    """One program a run, whatever the rounds sample.  A split-family
    round replays its own steps only, ``short`` where some round runs
    fewer than the longest (SL/SFLv2: the run's longest round; SFLv3/v1:
    the table's ``NB_N`` rows): 2 rounds, as a third would make every
    spec here uneven.  FL steps its fixed ``[S, NB]`` grid."""
    st, _, logs = _port_run(clients, method, Participation(**SPECS[kind]))
    assert len(st._programs) == 1
    prog = next(iter(st._programs.values()))
    assert prog.n_steps == len(prog.rows)
    assert prog.slot_gid.shape == (2,)
    if short is None:
        assert prog.n_steps == 2 * max(SIZES) // BATCH
        return
    steps = [l.steps for l in logs]
    assert prog.n_steps == steps[-1]
    sync = method.startswith(("sflv3", "sflv1"))
    longest = len(prog.table) if sync else max(steps)
    assert len(prog.table) == (max(SIZES) // BATCH if sync
                               else sum(s // BATCH for s in SIZES))
    assert any(s < longest for s in steps) is short


@pytest.mark.parametrize("method", ["sflv2_ac", "sflv3_ac"])
def test_a_later_run_may_sample_longer_rounds(clients, method):
    """The rounds restart at 0 each ``run``, so a later, longer run can
    sample a longer round than any of the first run's.  The program the
    first run built (its step table sized by the layout, not by the run)
    steps it, and trains as a fresh strategy does from the same state."""
    part = Participation(**FIXED)       # rounds 0 and 1 sample (1, 2)
    st, state, logs = _port_run(clients, method, part)
    prog = next(iter(st._programs.values()))
    data = [c.train for c in clients]
    start = copy.deepcopy(state)
    state, later = st.run(state, data, np.random.default_rng(2), BATCH, 5)
    assert max(l.steps for l in later) > max(l.steps for l in logs)
    assert list(st._programs.values()) == [prog]
    fresh = make_strategy(method, adapters("tiny", False)[1],
                          lambda: TO.adam(LR), 3, participation=part,
                          device="cpu")
    start, again = fresh.run(start, data, np.random.default_rng(2), BATCH,
                             5)
    assert [l.losses for l in again] == [l.losses for l in later]
    for pa, pb in zip(_params(st, state), _params(fresh, start)):
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))


# ---------------------------------------------------------------------------
# the combinations the reference refuses
# ---------------------------------------------------------------------------

REFUSED = [
    ("centralized", dict(participation=FIXED)),
    ("fl", dict(participation=FIXED, engine="stepwise")),
    ("fl", dict(participation=FIXED, privacy=dict(secagg=True))),
    ("fl", dict(participation=dict(n_global=5, k=2))),
    ("sl_ac", dict(participation=dict(n_global=3, q=0.5))),
    ("sflv3_ac", dict(participation=dict(n_global=3, schedule=((0,),)))),
    ("sl_ac", dict(aggregator="trimmed_mean")),
    ("fl", dict(aggregator="trimmed_mean", privacy=dict(secagg=True))),
    ("fl", dict(aggregator="no_such_rule")),
]


@pytest.mark.parametrize("method, kw", REFUSED)
def test_refused_combinations_raise_the_references_error(method, kw):
    ja, ta = adapters("tiny", False)
    kj, kt = dict(kw), dict(kw)
    if "participation" in kw:
        kj["participation"] = JP.Participation(**kw["participation"])
        kt["participation"] = Participation(**kw["participation"])
    if "privacy" in kw:
        kj["privacy"] = JPrivacy(**kw["privacy"])
        kt["privacy"] = PrivacyConfig(**kw["privacy"])
    with pytest.raises(ValueError) as ej:
        s = j_make_strategy(method, ja, lambda: JO.adam(LR), 3, **kj)
        s.setup(jax.random.key(0))
    with pytest.raises(ValueError) as et:
        make_strategy(method, ta, lambda: TO.adam(LR), 3, device="cpu",
                      **kt)
    assert str(et.value) == str(ej.value)
