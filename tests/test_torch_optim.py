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
  rate frozen at the first step would break it); and it refuses
  ``add_noise``, whose generator a captured graph would replay frozen.
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
    assert not opt.capturable and not TO.chain(TO.sgd(0.1), opt).capturable


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


def test_compiled_engine_refuses_add_noise():
    ad = cnn_adapter(build_densenet(DenseNetConfig(
        growth=4, blocks=(1, 1), stem_ch=8, cut_layer=1)))
    noisy = lambda: TO.chain(TO.add_noise(0.1), TO.adam(1e-3))  # noqa: E731
    st = make_strategy("fl", ad, noisy, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="add_noise"):
        st.run(st.setup(0), _clients(), np.random.default_rng(0), 8, 1)
    with pytest.raises(NotImplementedError, match="add_noise"):
        st.run_epoch(st.setup(0), _clients(), np.random.default_rng(0), 8)
    sw = make_strategy("fl", ad, noisy, 2, engine="stepwise", device="cpu")
    _, logs = sw.run(sw.setup(0), _clients(), np.random.default_rng(0), 8, 1)
    assert np.isfinite(logs[0].losses).all()
