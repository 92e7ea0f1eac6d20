"""The host side of ``repro_torch.obs`` against ``repro.obs``, on the CPU,
and the tensor taps against the reference's on the same tensors:

  * the reducers (``rounds_client_major``, ``rounds_participation``,
    ``rounds_scheduled``, ``rounds_sync``, ``pack_client_major``), the
    ``RunTelemetry`` views (``metric``, ``to_json``, ``table``) and
    ``epsilon_rounds`` (at most 5 steps per sampling rate), each fed the
    same numpy inputs in both packages: equal outputs, bit for bit;
  * ``trace.round_events`` of the same telemetry and dispatch span, and
    ``report.write_runlog`` / ``render_markdown`` / ``write_report``:
    the same events and the same files;
  * a strategy's tracer spans (``run``, ``pack``, ``dispatch``, ``round
    i``) in the reference's names and order, on both engines, among the
    port's own (``h2d`` and the device lane's ``replay.<body>``: the
    compiled SFLv3 list pinned);
  * ``profile``: ``torch_profile`` writes a Chrome trace on the CPU,
    ``graph_cost`` is None before a compiled run and describes the last
    run's program after one, and ``cost_summary`` keeps the reference's
    keys, its dispatches the run's replays;
  * the taps (``global_norm``, ``payload_moments`` on a channels-last
    leaf, ``combine_moments``, ``moments_to_stats``, ``clip_fraction``,
    ``update_cosine``, ``observing_boundary``) within 1e-6 relative of
    the reference's jnp versions on the same inputs.
"""

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.core import participation as JP
from repro.core.strategies import engine as JENG
from repro.core.strategies import make_strategy as j_make_strategy
from repro.data.synthetic import make_cxr_clients
from repro.obs import report as JR
from repro.obs import telemetry as JT
from repro.obs import trace as JTR
from repro.privacy import PrivacyConfig as JPrivacy
from repro_torch import optim as TO
from repro_torch.core.strategies import make_strategy
from repro_torch.obs import (Telemetry, cost_summary, graph_cost,
                             torch_profile)
from repro_torch.obs import report as TR
from repro_torch.obs import telemetry as T
from repro_torch.obs import trace as TTR
from repro_torch.privacy import PrivacyConfig
from torch_grid_pair import adapters, port_state

torch.set_num_threads(2)

SPECS = [T.Telemetry(), T.Telemetry(loss=False),
         T.Telemetry(norms=False, cut_stats=False)]


def _jspec(spec):
    return JT.Telemetry(**{f: getattr(spec, f) for f in (
        "loss", "norms", "update_cosine", "cut_stats", "clip_fraction",
        "epsilon")})


def _json(rounds):
    return [r.to_json() for r in rounds]


def _equal_rounds(a, b):
    """The same rounds, bit for bit (JSON writes NaN as NaN)."""
    assert json.dumps(_json(a)) == json.dumps(_json(b))
    assert json.dumps([r.scalars() for r in a]) == json.dumps(
        [r.scalars() for r in b])


@pytest.mark.parametrize("spec", SPECS, ids=["all", "noloss", "subset"])
def test_reducers_match_the_reference(spec):
    rng = np.random.default_rng(0)
    E, C, NB = 2, 4, 3
    losses = rng.random((E, C, NB))
    mets = {"grad_norm": rng.random((E, C, NB)),
            "update_norm": rng.random((E, C, NB))}
    mask = rng.random((C, NB)) > 0.3
    mask[1] = False                                 # a hospital without steps
    extra = {"update_cosine": rng.uniform(-1, 1, (E, C))}
    _equal_rounds(
        JT.rounds_client_major(_jspec(spec), losses, mets, mask, 3, extra),
        T.rounds_client_major(spec, losses, mets, mask, 3, extra))
    sched = np.array([(0, 0), (2, 0), (0, 1), (1, 0), (2, 1)])
    flat = rng.random((E, len(sched)))
    fm = {"cut_mean": rng.random((E, len(sched)))}
    _equal_rounds(JT.rounds_scheduled(_jspec(spec), flat, fm, sched, 3),
                  T.rounds_scheduled(spec, flat, fm, sched, 3))
    sync = rng.random((E, 3, 4))
    sm = {"clip_frac": rng.random((E, 3, 4))}
    _equal_rounds(JT.rounds_sync(_jspec(spec), sync, sm, 3),
                  T.rounds_sync(spec, sync, sm, 3))
    vals = list(rng.random(6))
    for a, b in zip(JT.pack_client_major(vals, [3, 0, 2, 1]),
                    T.pack_client_major(vals, [3, 0, 2, 1])):
        np.testing.assert_array_equal(a, b)


def test_participation_reducer_matches_the_reference():
    data = [{"image": np.zeros((n, 2), np.float32),
             "label": np.zeros((n,), np.float32)} for n in (9, 5, 7, 3)]
    part = JP.Participation(n_global=4, k=2, seed=3)
    _, pack = JENG.pack_participation_run(data, 2, np.random.default_rng(0),
                                          3, part)
    rng = np.random.default_rng(1)
    shape = pack.mask.shape
    losses, mets = rng.random(shape), {"grad_norm": rng.random(shape)}
    extra = {"update_cosine": rng.uniform(-1, 1, shape[:2])}
    ja = JT.rounds_participation(JT.Telemetry(), losses, mets, pack, extra)
    ta = T.rounds_participation(T.Telemetry(), losses, mets, pack, extra)
    _equal_rounds(ja, ta)
    assert all(r.participation is not None for r in ta)


def _run_telemetry(pkg, eps=True):
    rng = np.random.default_rng(2)
    rounds = [pkg.RoundTelemetry(e, {
        "loss": rng.random(3), "grad_norm": np.array([1.0, np.nan, 2.5]),
        "cut_mean": rng.random(3)}) for e in range(3)]
    if eps:
        for e, r in enumerate(rounds):
            r.epsilon = np.array([0.5, 1.0, 1.5]) * (e + 1)
    rounds[1].participation = np.array([0, 2])
    return pkg.RunTelemetry("sflv3_ac", 3, rounds)


def test_run_telemetry_views_match_the_reference():
    for eps in (True, False):
        rj, rt = _run_telemetry(JT, eps), _run_telemetry(T, eps)
        assert rt.table() == rj.table()
        assert json.dumps(rt.to_json()) == json.dumps(rj.to_json())
        for k in ("loss", "grad_norm", "missing"):
            np.testing.assert_array_equal(rt.metric(k), rj.metric(k))
    assert T.RunTelemetry("fl", 3, []).table() == JT.RunTelemetry(
        "fl", 3, []).table()


@pytest.mark.parametrize("kw", [
    {}, dict(pooled=True), dict(q_scale=0.5, steps_override=[2, 1, 2])],
    ids=["per-hospital", "pooled", "amplified"])
def test_epsilon_rounds_match_the_reference(kw):
    logs = [SimpleNamespace(steps=2, client_steps=[2, 1, 0]),
            SimpleNamespace(steps=2, client_steps=[1, 2, 2])]
    args = ([17, 12, 9], 4)
    ej = JT.epsilon_rounds(JPrivacy(noise_multiplier=1.1, clip_norm=1.0),
                           logs, *args, **kw)
    et = T.epsilon_rounds(PrivacyConfig(noise_multiplier=1.1, clip_norm=1.0),
                          logs, *args, **kw)
    np.testing.assert_array_equal(et, ej)
    assert T.epsilon_rounds(None, logs, *args) is None
    assert T.epsilon_rounds(PrivacyConfig(cut_noise_std=0.5), logs,
                            *args) is None


@pytest.mark.parametrize("span", [None, {"ts": 120.5, "dur": 3000.0}],
                         ids=["unit", "dispatch"])
def test_round_events_match_the_reference(span):
    ej = JTR.round_events(_run_telemetry(JT), span)
    et = TTR.round_events(_run_telemetry(T), span)
    assert json.dumps(et) == json.dumps(ej)
    assert TTR.round_events(T.RunTelemetry("fl", 3, [])) == []


def test_reports_match_the_reference(tmp_path):
    cost = {"strategy": "sflv3_ac", "dispatches": 12,
            "graph": {"replays": {"step": 10}}, "wall_seconds": 1.5}
    rj, rt = _run_telemetry(JT), _run_telemetry(T)
    assert TR.render_markdown(rt, cost) == JR.render_markdown(rj, cost)
    assert TR.render_markdown(rt, None, "x") == JR.render_markdown(rj, None,
                                                                   "x")
    for fn in ("write_runlog", "write_report"):
        kw = dict(extra={"wire": {"bytes": 3}}) if fn == "write_runlog" \
            else {}
        a = getattr(JR, fn)(tmp_path / "ref", "run", rj, cost=cost, **kw)
        b = getattr(TR, fn)(tmp_path / "port", "run", rt, cost=cost, **kw)
        assert open(a).read() == open(b).read()
    assert json.load(open(TR.write_runlog(tmp_path, "bare"))) == {
        "name": "bare"}


# ---------------------------------------------------------------------------
# strategies: spans, dispatches, graph_cost, torch_profile
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, train_per_client=[17, 12, 9],
                            val_per_client=6, test_per_client=7,
                            image_size=16, n_clients=3)


@pytest.mark.parametrize("method, engine", [("fl", "compiled"),
                                            ("sflv3_ac", "compiled"),
                                            ("sl_am", "stepwise")])
def test_spans_are_the_references(clients, method, engine):
    ja, ta = adapters("tiny", False)
    names = []
    for pkg in ("ref", "port"):
        if pkg == "ref":
            st = j_make_strategy(method, ja, lambda: JO.adam(1e-3), 3,
                                 engine=engine, observe=True)
            state = st.setup(jax.random.key(0))
            tracer = st.attach_tracer(JTR.Tracer())
        else:
            st = make_strategy(method, ta, lambda: TO.adam(1e-3), 3,
                               engine=engine, device="cpu", observe=True)
            state = st.setup(0)
            tracer = st.attach_tracer(TTR.Tracer())
        st.run(state, [c.train for c in clients], np.random.default_rng(1),
               4, 2)
        names.append([e["name"] for e in tracer.events])
        run = tracer.find("run")
        assert run["args"]["n_epochs"] == 2 and run["args"]["depth"] == 0
    # the reference's spans, in its order, among the port's own (the copy
    # to the card, ``h2d``, and the replays on the device lane)
    assert [n for n in names[1] if n in names[0]] == names[0]
    assert names[1][-1] == "run"
    if method == "sflv3_ac":
        # 17/12/9 images at batch 4: 4 joint steps a round, two rounds
        rnd = ["replay.begin"] + ["replay.step"] * 4 + ["replay.round"]
        assert names[1] == ["pack", "h2d", "h2d", *rnd, *rnd, "dispatch",
                            "run"]
    elif engine == "compiled":
        assert [n for n in names[1] if not n.startswith("replay.")] == [
            "pack", "h2d", "h2d", "dispatch", "run"]
    else:
        assert names[1] == names[0]


def test_graph_cost_and_cost_summary(clients):
    _, ta = adapters("tiny", False)
    st = make_strategy("sflv2_ac", ta, lambda: TO.adam(1e-3), 3,
                       device="cpu")
    assert graph_cost(st) is None
    assert cost_summary(st) == {"strategy": "sflv2_ac",
                                "engine": "compiled", "dispatches": 0,
                                "run_calls": 0}
    state = st.setup(0)
    st.run(state, [c.train for c in clients], np.random.default_rng(1), 4,
           2, observe=Telemetry())
    g = graph_cost(st)
    steps = 2 * (4 + 3 + 2)                         # SFLv2-AC: every batch
    assert g["program"] == "InterleavedProgram"
    assert g["replays"] == {"step": steps, "round": 2}
    assert g["captures"] == {"step": 0, "round": 0}  # the CPU captures none
    assert g["step_flops"] > 0 and g["peak_bytes"] is None
    cost = cost_summary(st, wall_seconds=2.0, total_steps=steps)
    assert cost["dispatches"] == steps + 2 and cost["run_calls"] == 1
    assert cost["steps_per_s"] == steps / 2.0 and cost["graph"] == g
    stepwise = make_strategy("sflv2_ac", ta, lambda: TO.adam(1e-3), 3,
                             engine="stepwise", device="cpu")
    stepwise.run(stepwise.setup(0), [c.train for c in clients],
                 np.random.default_rng(1), 4, 1)
    assert graph_cost(stepwise) is None
    assert cost_summary(stepwise)["dispatches"] == 4 + 3 + 2


def test_torch_profile_writes_a_trace_on_the_cpu(tmp_path, clients):
    _, ta = adapters("tiny", False)
    st = make_strategy("fl", ta, lambda: TO.adam(1e-3), 3, device="cpu")
    state = st.setup(0)
    with torch_profile(tmp_path / "prof") as prof:
        st.run(state, [c.train for c in clients], np.random.default_rng(1),
               4, 1, observe=True)
    trace = json.load(open(prof.trace_path))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("conv" in str(n) for n in names)


def test_stepwise_taps_match_the_reference(clients):
    """The stepwise engines' observed centralized epoch from the same
    converted start: the same key sets, values within 1e-4 (the compiled
    rows are held in ``tests/test_torch_obs.py``)."""
    ja, ta = adapters("tiny", False)
    sj = j_make_strategy("centralized", ja, lambda: JO.adam(1e-3), 3,
                         engine="stepwise", observe=True)
    state_j = sj.setup(jax.random.key(0))
    st = make_strategy("centralized", ta, lambda: TO.adam(1e-3), 3,
                       engine="stepwise", device="cpu", observe=True)
    state_t = port_state("centralized", jax.tree.map(np.asarray, state_j))
    data = [c.train for c in clients]
    sj.run(state_j, data, np.random.default_rng(1), 4, 1)
    st.run(state_t, data, np.random.default_rng(1), 4, 1)
    a, b = sj.last_run_telemetry.rounds, st.last_run_telemetry.rounds
    assert [set(r.metrics) for r in a] == [set(r.metrics) for r in b]
    for k in a[0].metrics:
        np.testing.assert_allclose(b[0].metrics[k], a[0].metrics[k],
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_taps_match_the_reference_on_the_same_tensors():
    """The tensor taps against the reference's jnp ones on the same
    inputs: norms, payload moments (with and without weights, a
    channels-last leaf among them), their per-example fold, the clip
    fraction and the update cosine, within 1e-6 relative (f32 sums in
    another order)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((4, 3, 5, 5)).astype(np.float32),
            "b": rng.standard_normal((4, 7)).astype(np.float32)}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    tt["a"] = tt["a"].contiguous(memory_format=torch.channels_last)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    w = np.array([1, 0, 1, 1], np.float32)

    def close(a, b):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-6,
                                   atol=1e-7)
    close(T.global_norm(tt), JT.global_norm(jt))
    close(T.sq_norms(tt, {"b": tt["b"]}).sqrt(),
          [JT.global_norm(jt), JT.global_norm({"b": jt["b"]})])
    for weights in (None, w):
        got = T.payload_moments(tt, None if weights is None
                                else torch.from_numpy(weights))
        want = JT.payload_moments(jt, None if weights is None
                                  else jnp.asarray(weights))
        for g, x in zip(got, want):
            close(g, x)
        stats = T.moments_to_stats(*got)
        for k, v in JT.moments_to_stats(*want).items():
            close(stats[k], v)
    per = [rng.random(4).astype(np.float32) for _ in range(3)]
    for weights in (None, w):
        got = T.combine_moments(*map(torch.from_numpy, per),
                                None if weights is None
                                else torch.from_numpy(weights))
        want = JT.combine_moments(*map(jnp.asarray, per),
                                  None if weights is None
                                  else jnp.asarray(weights))
        for g, x in zip(got, want):
            close(g, x)
    norms = np.array([0.5, 1.5, 2.5, 0.9], np.float32)
    for weights in (None, w):
        close(T.clip_fraction(torch.from_numpy(norms), 1.0,
                              None if weights is None
                              else torch.from_numpy(weights)),
              JT.clip_fraction(jnp.asarray(norms), 1.0,
                               None if weights is None
                               else jnp.asarray(weights)))
    glob = {k: v[0] for k, v in tree.items()}
    new = {k: v[1] for k, v in tree.items()}
    stacked = {k: v.copy() for k, v in tree.items()}
    stacked["a"][2] = glob["a"]                   # a zero delta: cosine 0
    stacked["b"][2] = glob["b"]
    got = T.update_cosine(*({k: torch.from_numpy(v) for k, v in t.items()}
                            for t in (stacked, glob, new)))
    want = JENG._update_cosine(*({k: jnp.asarray(v) for k, v in t.items()}
                                 for t in (stacked, glob, new)))
    close(got, want)
    assert float(got[2]) == 0.0
    sink = []
    hook = T.observing_boundary(None, sink)
    assert hook(tt) is tt and sink == [tt]
