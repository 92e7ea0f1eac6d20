"""The aggregation rules (``core.aggregate``) in the port against
``repro``, on the CPU.

  * every rule's ``aggregate`` on the same stacked updates, raw weights
    (all positive, with zero-weight rows holding outliers, all zero),
    staleness and slot -> global ids as the reference's, within 1e-6;
    the list-of-trees form (``aggregate_trees``, the stepwise engine's)
    the same; the zero-weight round keeps ``prev`` exactly;
  * the registry (``make_aggregator``, ``register``) and every rule's
    parameter checks raise the reference's errors;
  * FL under each registered rule: the port's compiled engine (the rule
    inside the round body) equal to its stepwise engine, and a
    participating 3-round run (a schedule, so a hospital re-enters with
    staleness 1) against the reference's compiled run from the same
    weights and batches: losses within 1e-4, params within 1e-6 (1% of
    lr), on the tiny DenseNet at 16x16, 3 hospitals of 17, 12 and 9
    images, batch 4 (the sizes of ``tests/test_participation.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.core import aggregate as JAGG
from repro.core import participation as JP
from repro.core.strategies import make_strategy as j_make_strategy
from repro.data.synthetic import make_cxr_clients
from repro_torch import optim as TO
from repro_torch.core import aggregate as AGG
from repro_torch.core.participation import Participation
from repro_torch.core.strategies import make_strategy
from repro_torch.interop import params_to_numpy
from repro_torch.tree import tree_leaves, tree_map
from torch_grid_pair import adapters, flat, port_state

torch.set_num_threads(2)

BATCH, LR, TOL = 4, 1e-4, 1e-4
PARAM_TOL = 0.01 * LR
SIZES = [17, 12, 9]
SCHEDULE = ((0, 1), (1, 2), (0, 2))
REGIONS = (0, 0, 1, 1, 2)


def _rules(pkg):
    """(name, rule) of every registered rule with set parameters."""
    m = JAGG if pkg == "repro" else AGG
    return [("weighted_mean", m.WeightedMean()),
            ("trimmed_mean", m.TrimmedMean(0.2)),
            ("trimmed_mean_0", m.TrimmedMean(0.0)),
            ("coordinate_median", m.CoordinateMedian()),
            ("staleness_discounted", m.StalenessDiscounted(0.5)),
            ("hierarchical", m.Hierarchical(REGIONS))]


RULES = [n for n, _ in _rules("port")]
WEIGHTS = {"positive": [3.0, 1.0, 4.0, 1.0, 5.0],
           "zero_rows": [3.0, 0.0, 4.0, 0.0, 5.0],
           "even_valid": [3.0, 0.0, 4.0, 2.0, 0.0],
           "all_zero": [0.0] * 5}
CONTEXT = {"none": (None, None),
           "participation": ([0.0, 2.0, 0.0, 1.0, 3.0], [4, 0, -1, 2, 3])}


def _stacked(seed=0, rows=5):
    rng = np.random.default_rng(seed)
    tree = {"a": rng.normal(size=(rows, 3, 4)),
            "b": {"c": rng.normal(size=(rows, 7)),
                  "ties": rng.integers(-2, 3, size=(rows, 6)).astype(float)}}
    tree = jax.tree.map(lambda x: x.astype(np.float32), tree)
    # row 1 carries outliers: where its weight is 0, a rule that reads it
    # fails
    for leaf in jax.tree.leaves(tree):
        leaf[1] += 1e3
    return tree


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _both(rule, weights, context, trees=False):
    stacked = _stacked()
    prev = jax.tree.map(lambda x: np.full(x.shape[1:], 7.0, np.float32),
                        stacked)
    rj = dict(_rules("repro"))[rule]
    rt = dict(_rules("port"))[rule]
    st, gids = context
    w = np.asarray(weights, np.float32)
    if trees:
        rows = [jax.tree.map(lambda x, i=i: x[i], stacked) for i in range(5)]
        oj = rj.aggregate_trees(rows, list(weights), prev)
        ot = rt.aggregate_trees([tree_map(torch.from_numpy, r)
                                 for r in rows], list(weights),
                                tree_map(torch.from_numpy, prev))
    else:
        oj = rj.aggregate(jax.tree.map(jnp.asarray, stacked), jnp.asarray(w),
                          jax.tree.map(jnp.asarray, prev),
                          None if st is None else jnp.asarray(st,
                                                              jnp.float32),
                          None if gids is None else jnp.asarray(gids,
                                                                jnp.int32))
        ot = rt.aggregate(tree_map(torch.from_numpy, stacked),
                          torch.from_numpy(w), tree_map(torch.from_numpy,
                                                        prev),
                          None if st is None else torch.tensor(st),
                          None if gids is None else torch.tensor(gids))
    return flat(_np_tree(oj)), flat(ot), flat(prev)


@pytest.mark.parametrize("context", list(CONTEXT))
@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("rule", RULES)
def test_aggregate_is_the_references(rule, weights, context):
    fj, ft, fp = _both(rule, WEIGHTS[weights], CONTEXT[context])
    assert list(ft) == list(fj)
    for k in fj:
        assert ft[k].dtype == np.float32
        np.testing.assert_allclose(ft[k], fj[k], rtol=1e-6, atol=1e-6,
                                   err_msg=str(k))
        if weights == "all_zero":
            np.testing.assert_array_equal(ft[k], fp[k])
        elif WEIGHTS[weights][1] == 0:
            assert np.abs(ft[k]).max() < 100     # no outlier row counted


@pytest.mark.parametrize("weights", ["positive", "zero_rows"])
@pytest.mark.parametrize("rule", RULES)
def test_aggregate_trees_is_the_references(rule, weights):
    fj, ft, _ = _both(rule, WEIGHTS[weights], CONTEXT["none"], trees=True)
    for k in fj:
        np.testing.assert_allclose(ft[k], fj[k], rtol=1e-6, atol=1e-6,
                                   err_msg=str(k))


@pytest.mark.parametrize("rule", RULES)
def test_aggregate_repeats_bit_for_bit(rule):
    _, a, _ = _both(rule, WEIGHTS["zero_rows"], CONTEXT["participation"])
    _, b, _ = _both(rule, WEIGHTS["zero_rows"], CONTEXT["participation"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_weighted_mean_multiplies_by_the_reciprocal():
    """The mean is the weighted row sum times 1/total, added in row
    order: on the card, ATen's division of a tensor by a host scalar."""
    stacked = tree_map(torch.from_numpy, _stacked())
    w = torch.tensor(WEIGHTS["zero_rows"])
    out = AGG.WeightedMean().aggregate(stacked, w,
                                       tree_map(lambda x: x[0], stacked))
    for x, o in zip(tree_leaves(stacked), tree_leaves(out)):
        acc = x[0] * w[0]
        for i in range(1, 5):
            acc = acc + x[i] * w[i]
        assert torch.equal(o, acc * torch.reciprocal(w.sum()))


def test_registry_and_checks_are_the_references():
    assert sorted(AGG.AGGREGATORS) == sorted(JAGG.AGGREGATORS)
    assert isinstance(AGG.make_aggregator(None), AGG.WeightedMean)
    for name in AGG.AGGREGATORS:
        if name != "hierarchical":
            assert AGG.make_aggregator(name).name == name
    rule = AGG.TrimmedMean(0.3)
    assert AGG.make_aggregator(rule) is rule
    for bad, exc in [("nope", ValueError), (3, TypeError)]:
        with pytest.raises(exc) as ej:
            JAGG.make_aggregator(bad)
        with pytest.raises(exc) as et:
            AGG.make_aggregator(bad)
        assert str(et.value) == str(ej.value)
    for make in [lambda m: m.TrimmedMean(0.5), lambda m: m.TrimmedMean(-0.1),
                 lambda m: m.StalenessDiscounted(0.0),
                 lambda m: m.StalenessDiscounted(1.5),
                 lambda m: m.Hierarchical((0, -1))]:
        with pytest.raises(ValueError) as ej:
            make(JAGG)
        with pytest.raises(ValueError) as et:
            make(AGG)
        assert str(et.value) == str(ej.value)

    class Half(AGG.Aggregator):
        name = "half"

        def aggregate(self, stacked, weights, prev, staleness=None,
                      gids=None):
            return tree_map(lambda p: p / 2, prev)
    AGG.register("half", Half)
    try:
        assert isinstance(AGG.make_aggregator("half"), Half)
    finally:
        del AGG.AGGREGATORS["half"]
    with pytest.raises(RuntimeError, match="host-side"):
        AGG.SecAggregator(None).aggregate({}, torch.ones(1), {})


@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, train_per_client=SIZES,
                            val_per_client=6, test_per_client=7,
                            image_size=16, n_clients=3)


def _hospital_rules(pkg):
    m = JAGG if pkg == "repro" else AGG
    return {"trimmed_mean": m.TrimmedMean(0.34),
            "coordinate_median": m.CoordinateMedian(),
            "staleness_discounted": m.StalenessDiscounted(0.5),
            "hierarchical": m.Hierarchical((0, 1, 1))}


@pytest.mark.parametrize("rule", list(_hospital_rules("port")))
def test_fl_compiled_round_equals_stepwise(clients, rule):
    ta = adapters("tiny", False)[1]
    out = {}
    for engine in ("stepwise", "compiled"):
        st = make_strategy("fl", ta, lambda: TO.adam(LR), 3, engine=engine,
                           aggregator=_hospital_rules("port")[rule],
                           device="cpu")
        state, logs = st.run(st.setup(0), [c.train for c in clients],
                             np.random.default_rng(1), BATCH, 2)
        out[engine] = (logs, tree_leaves(state["params"]))
    (la, pa), (lb, pb) = out["stepwise"], out["compiled"]
    assert [l.losses for l in la] == [l.losses for l in lb]
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))


@pytest.mark.parametrize("rule", list(_hospital_rules("port")))
def test_participating_fl_rule_matches_the_reference(clients, rule):
    ja, ta = adapters("tiny", False)
    sj = j_make_strategy("fl", ja, lambda: JO.adam(LR), 3,
                         aggregator=_hospital_rules("repro")[rule],
                         participation=JP.Participation(n_global=3,
                                                        schedule=SCHEDULE))
    st = make_strategy("fl", ta, lambda: TO.adam(LR), 3,
                       aggregator=_hospital_rules("port")[rule],
                       participation=Participation(n_global=3,
                                                   schedule=SCHEDULE),
                       device="cpu")
    state_j = sj.setup(jax.random.key(0))
    state_t = port_state("fl", jax.tree.map(np.asarray, state_j))
    data = [c.train for c in clients]
    state_j, lj = sj.run(state_j, data, np.random.default_rng(1), BATCH, 3)
    state_t, lt = st.run(state_t, data, np.random.default_rng(1), BATCH, 3)
    for a, b in zip(lj, lt, strict=True):
        assert (b.steps, b.weights, b.client_steps) == (
            a.steps, a.weights, a.client_steps)
        np.testing.assert_allclose(b.losses, a.losses, atol=TOL, rtol=0)
    fj = flat(_np_tree(state_j["params"]))
    ft = flat(params_to_numpy(state_t["params"]))
    assert list(ft) == list(fj)
    for k in fj:
        np.testing.assert_allclose(ft[k], fj[k], atol=PARAM_TOL, rtol=0,
                                   err_msg=str(k))
