"""The port's optimizers and schedules (``repro_torch.optim``) against
``repro.optim``, on the CPU.

* 20 steps on fixed gradients (the same seeded numpy draws into both
  packages) within 1e-6 of the reference at every step: SGD with and
  without momentum, Adam under a callable lr, with AdamW decay and with a
  bf16 state, ``clip_by_global_norm`` alone and chained, ``add_noise``
  with the same normal draws injected into both packages.
* ``constant``, ``cosine_warmup`` and ``wsd`` at steps 0 to 40, from Python
  ints and from device step counts, within 1e-6 relative.
* The compiled engine on a schedule and decay: bit-equal to the stepwise
  engine for SFLv3 and SL-AM, with each step's rate the schedule's (a
  rate frozen at the first step would break it).
* ``add_noise``'s counter-based stream: Threefry-2x32 bit-equal to the
  reference's ``threefry_2x32``, N(0, 1) moments, the reference's chain
  properties (clip then noise, zero std, bf16 Adam state), and the
  compiled engine under ``chain(clip_by_global_norm, add_noise, adam)``
  bit-equal to the stepwise engine on FL (hospitals of unequal batch
  counts, so masked steps) and SFLv3, each step body drawing new noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.optim import optimizers as j_optimizers
from repro_torch import optim as TO
from repro_torch.core.partition import cnn_adapter
from repro_torch.core.strategies import make_strategy
from repro_torch.models.cnn import DenseNetConfig, build_densenet
from repro_torch.optim import optimizers as t_optimizers
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

STEPS, TOL = 20, 1e-6
SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}, "e": (7,)}


def _tree(fn, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v) for k, v in shapes.items()}
    return fn(shapes)


def _draws(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [_tree(lambda s: (scale * rng.normal(size=s)).astype(np.float32))
            for _ in range(STEPS)]


def _leaves(tree):
    return [np.asarray(l, np.float32) for l in jax.tree.leaves(tree)]


def _run_both(j_opt, t_opt, grad_scale=1.0):
    """Both packages from the same params through STEPS updates on the same
    gradients; every step's params compared."""
    p0 = _draws(0)[0]
    grads = _draws(1, grad_scale)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = jax.tree.map(torch.from_numpy, p0)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    worst = 0.0
    for g in grads:
        ju, js = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = JO.apply_updates(jp, ju)
        tu, ts = t_opt.update(jax.tree.map(torch.from_numpy, g), ts, tp)
        tp = TO.apply_updates(tp, tu)
        for a, b in zip(_leaves(jp), [l.numpy() for l in tree_leaves(tp)]):
            worst = max(worst, float(np.abs(a - b).max()))
    assert worst <= TOL, worst
    return js, ts


OPTS = {
    "sgd": lambda O: O.sgd(0.05),
    "sgd_momentum": lambda O: O.sgd(0.05, momentum=0.9),
    "sgd_wsd": lambda O: O.sgd(O.wsd(0.05, 4, 6, 8), momentum=0.5),
    "adam_cosine": lambda O: O.adam(O.cosine_warmup(1e-2, 5, 20)),
    "adam_constant": lambda O: O.adam(O.constant(1e-2)),
    "adamw": lambda O: O.adam(1e-2, weight_decay=0.1),
    "adamw_cosine": lambda O: O.adam(O.cosine_warmup(1e-2, 3, 15, 1e-3),
                                     weight_decay=1e-2),
    "clip": lambda O: O.clip_by_global_norm(1.0),
    "clip_adam": lambda O: O.chain(O.clip_by_global_norm(0.5),
                                   O.adam(1e-2, weight_decay=1e-3)),
}


@pytest.mark.parametrize("name", list(OPTS))
def test_twenty_steps_match_reference(name):
    _run_both(OPTS[name](JO), OPTS[name](TO), grad_scale=3.0)


def test_adam_bf16_state_matches_reference():
    js, ts = _run_both(JO.adam(1e-2, state_dtype=jnp.bfloat16),
                       TO.adam(1e-2, state_dtype=torch.bfloat16))
    for a, b in zip(jax.tree.leaves(js["mu"]), tree_leaves(ts["mu"])):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())
    assert int(js["step"]) == int(ts["step"]) == STEPS


def test_add_noise_with_injected_draws(monkeypatch):
    """Each leaf's draws come, in both packages, from one table keyed by
    the leaf's shape and the draw's turn, so the reference's per-leaf key
    splits and the port's generator stream see the same numbers."""
    table, turns = {}, {"j": {}, "t": {}}

    def draw(side, shape):
        shape = tuple(shape)
        n = turns[side].get(shape, 0)
        turns[side][shape] = n + 1
        if (shape, n) not in table:
            table[shape, n] = np.random.default_rng(
                len(table)).normal(size=shape).astype(np.float32)
        return table[shape, n]

    monkeypatch.setattr(j_optimizers.jax.random, "normal",
                        lambda k, shape, dtype: jnp.asarray(draw("j", shape)))
    monkeypatch.setattr(t_optimizers, "_normal",
                        lambda shape, gen, device: torch.from_numpy(
                            draw("t", shape)))
    _run_both(JO.chain(JO.clip_by_global_norm(1.0), JO.add_noise(0.3, 5),
                       JO.adam(1e-2)),
              TO.chain(TO.clip_by_global_norm(1.0), TO.add_noise(0.3, 5),
                       TO.adam(1e-2)))
    assert turns["j"] == turns["t"] and sum(turns["t"].values()) == 4 * STEPS


def test_add_noise_draws_from_its_seeded_generator():
    opt = TO.add_noise(0.5, seed=3)
    g = {"w": torch.zeros(4, 6)}
    a, s = opt.update(g, opt.init(g))
    b, _ = opt.update(g, s)
    again, _ = opt.update(g, opt.init(g))
    assert torch.equal(a["w"], again["w"]) and not torch.equal(a["w"],
                                                               b["w"])
    assert TO.add_noise(0.0).update(g, {})[0] is g
    # the stream's state is one int64 count on the params' device
    assert s["count"].dtype == torch.int64 and int(s["count"]) == 1


SCHEDULES = {
    "constant": lambda O: O.constant(3e-4),
    "cosine": lambda O: O.cosine_warmup(1e-3, 10, 30),
    "cosine_floor": lambda O: O.cosine_warmup(2e-3, 0, 25, floor=1e-4),
    "wsd": lambda O: O.wsd(1e-3, 5, 10, 15),
    "wsd_no_warmup": lambda O: O.wsd(5e-4, 0, 3, 7, floor_frac=0.2),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_reference(name):
    j, t = SCHEDULES[name](JO), SCHEDULES[name](TO)
    want = np.asarray([float(j(s)) for s in range(41)], np.float32)
    from_ints = np.asarray([float(t(s)) for s in range(41)], np.float32)
    steps = torch.arange(41, dtype=torch.int64)
    from_counts = np.asarray([float(t(s)) for s in steps], np.float32)
    np.testing.assert_allclose(from_ints, want, rtol=TOL, atol=0)
    np.testing.assert_array_equal(from_counts, from_ints)
    assert t(steps[3]).dtype == torch.float32


# -- the engines under a schedule --------------------------------------------

def _clients(n=(16, 16)):
    return [{"image": np.random.default_rng(c).normal(
        0, 1, (nn, 16, 16, 1)).astype(np.float32),
        "label": (np.arange(nn) % 2).astype(np.float32)}
        for c, nn in enumerate(n)]


def _recording(schedule, seen):
    def lr(step):
        out = schedule(step)
        seen.append(float(out))
        return out
    return lr


@pytest.mark.parametrize("method", ["sflv3_ac", "sl_am"])
def test_engines_bit_equal_under_schedule_and_decay(method):
    ad = cnn_adapter(build_densenet(DenseNetConfig(
        growth=4, blocks=(1, 1), stem_ch=8, cut_layer=1)))
    sched = TO.cosine_warmup(1e-3, 2, 6)
    out, seen = {}, {}
    for engine in ("stepwise", "compiled"):
        seen[engine] = []
        st = make_strategy(method, ad, lambda e=engine: TO.adam(
            _recording(sched, seen[e]), weight_decay=1e-2), 2,
            engine=engine, device="cpu")
        state, logs = st.run(st.setup(0), _clients(), np.random.default_rng(0),
                             8, 2)
        out[engine] = (state, logs, st)
    (a, la, sa), (b, lb, sb) = out["stepwise"], out["compiled"]
    assert [l.losses for l in la] == [l.losses for l in lb]
    for c in range(2):
        for x, y in zip(tree_leaves(sa.params_for_eval(a, c)),
                        tree_leaves(sb.params_for_eval(b, c))):
            assert torch.equal(x, y)
    # every update took the schedule's rate at its own step count: the
    # server's counts run from 1 to the run's steps (SFLv3 2 a round, SL
    # 4), and no hospital's count passes them
    steps = sum(l.steps for l in lb)
    assert steps == (4 if method == "sflv3_ac" else 8)
    assert seen["stepwise"] == seen["compiled"]
    assert sorted(set(seen["compiled"])) == sorted(
        {float(sched(torch.tensor(s))) for s in range(1, steps + 1)})


# -- add_noise's stream and the compiled engine ------------------------------

def test_threefry_matches_reference_bits():
    from jax._src import prng
    rng = np.random.default_rng(0)
    key = rng.integers(0, 2 ** 32, 2, dtype=np.uint64)
    ctr = rng.integers(0, 2 ** 32, 64, dtype=np.uint64)
    want = np.asarray(prng.threefry_2x32(jnp.asarray(key, jnp.uint32),
                                         jnp.asarray(ctr, jnp.uint32)))
    x = torch.from_numpy(ctr.astype(np.int64))
    w0, w1 = t_optimizers.threefry2x32(int(key[0]), int(key[1]), x[:32],
                                       x[32:])
    np.testing.assert_array_equal(torch.cat([w0, w1]).numpy(),
                                  want.astype(np.int64))


def test_counter_normal_moments_and_streams():
    count = torch.tensor(1)
    z = t_optimizers._normal((200_000,), (0, count, 0), torch.device("cpu"))
    # N(0, 1): mean within 5 standard errors, variance within 2%
    assert abs(float(z.mean())) < 5 / np.sqrt(2e5)
    assert abs(float(z.var()) - 1) < 0.02 and bool(torch.isfinite(z).all())
    other = [t_optimizers._normal((1000,), k, torch.device("cpu"))
             for k in ((1, count, 0), (0, count + 1, 0), (0, count, 1))]
    assert all(not torch.equal(z[:1000], o) for o in other)
    again = t_optimizers._normal((1000,), (0, torch.tensor(1), 0),
                                 torch.device("cpu"))
    assert torch.equal(z[:1000], again)


def test_chain_properties_of_the_reference():
    """tests/test_privacy.py's chain properties on the port: clip then
    noise leaves the noise unbounded on top of the clipped gradient, noise
    then clip bounds the update; zero std is the identity and keeps the
    count; the bf16 Adam state rides along."""
    g = {"w": torch.full((512,), 100.0)}
    clip_noise = TO.chain(TO.clip_by_global_norm(1.0),
                          TO.add_noise(0.5, seed=1))
    noise_clip = TO.chain(TO.add_noise(0.5, seed=1),
                          TO.clip_by_global_norm(1.0))
    u1, _ = clip_noise.update(g, clip_noise.init(g))
    u2, _ = noise_clip.update(g, noise_clip.init(g))
    assert float(u2["w"].norm()) <= 1.0 + 1e-5
    assert float(u1["w"].norm()) > 1.0
    clipped, _ = TO.clip_by_global_norm(1.0).update(g, {})
    assert abs(float((u1["w"] - clipped["w"]).std()) - 0.5) < 0.1
    g = {"w": torch.arange(8.0)}
    out, s = TO.add_noise(0.0).update(g, TO.add_noise(0.0).init(g))
    assert torch.equal(out["w"], g["w"]) and int(s["count"]) == 0
    noisy = TO.add_noise(1.0)
    a, s = noisy.update(g, noisy.init(g))
    b, s = noisy.update(g, s)
    assert float((a["w"] - b["w"]).abs().max()) > 0
    p = {"w": torch.zeros(16)}
    opt = TO.chain(TO.clip_by_global_norm(1.0), TO.add_noise(0.1, seed=2),
                   TO.adam(1e-3, state_dtype=torch.bfloat16))
    up, state = opt.update({"w": torch.ones(16)}, opt.init(p), p)
    assert state[2]["mu"]["w"].dtype == torch.bfloat16
    assert bool(torch.isfinite(TO.apply_updates(p, up)["w"]).all())


def _noisy():
    return TO.chain(TO.clip_by_global_norm(1.0), TO.add_noise(0.05, seed=7),
                    TO.adam(1e-3))


@pytest.mark.parametrize("method,sizes", [("fl", (24, 8)),
                                          ("sflv3_ac", (16, 8))])
def test_compiled_engine_runs_add_noise_bit_equal(method, sizes,
                                                  monkeypatch):
    """FL over hospitals of 3 and 1 batches (the compiled grid masks two
    steps of the second) and SFLv3 (the second wraps around), 2 epochs:
    the compiled run equals the stepwise one bit for bit, and every step
    body drew at a new count (on the card each replay reads the advanced
    count inside the graph)."""
    ad = cnn_adapter(build_densenet(DenseNetConfig(
        growth=4, blocks=(1, 1), stem_ch=8, cut_layer=1)))
    counts = {}
    real = t_optimizers._normal

    def recording(shape, key, device):
        counts.setdefault(engine, []).append(int(key[1]))
        return real(shape, key, device)
    monkeypatch.setattr(t_optimizers, "_normal", recording)
    out = {}
    for engine in ("stepwise", "compiled"):
        st = make_strategy(method, ad, _noisy, 2, engine=engine,
                           device="cpu")
        state, logs = st.run(st.setup(0), _clients(sizes),
                             np.random.default_rng(0), 8, 2)
        out[engine] = (state, logs, st)
    (a, la, sa), (b, lb, sb) = out["stepwise"], out["compiled"]
    assert [l.losses for l in la] == [l.losses for l in lb]
    for c in range(2):
        for x, y in zip(tree_leaves(sa.params_for_eval(a, c)),
                        tree_leaves(sb.params_for_eval(b, c))):
            assert torch.equal(x, y)
    # the steps drew at counts 1, 2, ...: FL's local Adam starts fresh
    # each round (counts 1-3 per hospital), SFLv3's clients and server run
    # on (counts 1-4 over 2 epochs of 2 steps)
    top = 3 if method == "fl" else 4
    assert set(counts["stepwise"]) == set(range(1, top + 1))
    assert set(counts["compiled"]) >= set(range(1, top + 1))
