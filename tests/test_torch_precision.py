"""``precision="bf16"`` on the port (``partition.cast_adapter``): bf16
compute, f32 masters — the cases of ``tests/test_precision.py``, and the
port against the reference's bf16, on the CPU.

Setup: 3 hospitals of 24 images at 16x16, the tiny DenseNet of
``tests/test_system.py`` (and ``DENSENET_MINI``/``UNET_MINI``), batch 4,
Adam at 1e-3, the compiled engine (the default).  Bars:
  * masters, optimizer state and evaluation stay f32; evaluation is the
    f32 adapter's exactly;
  * |AUROC(bf16) - AUROC(fp32)| <= 0.05 after 2 epochs (DESIGN.md §13's
    gate, the reference's own);
  * the first step's losses within 1e-2 of the reference's bf16 losses
    from the same converted weights and batches: bf16 keeps 8 significant
    bits (an ulp is 3.9e-3 at a loss of 0.6), both packages round at the
    same casts but sum the convolutions in another order, and the first
    step has no update yet to amplify that; sound readings are at most
    1.6e-3;
  * wire bytes (bf16 boundary activations, identity and int8 links):
    exactly the reference's.
"""

import jax
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.core.strategies import make_strategy as j_make_strategy
from repro.data.synthetic import make_cxr_clients
from repro.wire import Transport as JTransport
from repro_torch import optim as TO
from repro_torch.core.partition import PRECISIONS, cast_adapter
from repro_torch.core.strategies import METHODS, make_strategy
from repro_torch.tree import tree_leaves
from repro_torch.wire import Transport
from torch_grid_pair import adapters, port_state

torch.set_num_threads(2)

LOSS_TOL = 1e-2


@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, n_clients=3, train_per_client=24,
                            val_per_client=8, test_per_client=16,
                            image_size=16)


def _train_eval(method, precision, clients, epochs=2, nls=False):
    """``epochs`` epochs from the reference's ``setup(key(0))`` weights,
    converted (the start of ``tests/test_precision.py``'s cases)."""
    ja, ta = adapters("tiny", nls)
    st = make_strategy(method, ta, lambda: TO.adam(1e-3), len(clients),
                       precision=precision, device="cpu")
    start = j_make_strategy(method, ja, lambda: JO.adam(1e-3),
                            len(clients)).setup(jax.random.key(0))
    state = port_state(method, jax.tree.map(np.asarray, start))
    state, logs = st.run(state, [c.train for c in clients],
                         np.random.default_rng(0), 4, epochs)
    return st, state, logs, st.evaluate(state, clients, "test",
                                        batch_size=8)


def test_cast_adapter_fp32_is_identity():
    ta = adapters("tiny", False)[1]
    assert cast_adapter(ta, "fp32") is ta


def test_cast_adapter_rejects_unknown_precision(clients):
    ta = adapters("tiny", False)[1]
    with pytest.raises(ValueError):
        cast_adapter(ta, "fp16")
    with pytest.raises(ValueError):
        make_strategy("sl_am", ta, lambda: TO.adam(1e-3), len(clients),
                      precision="tf32", device="cpu")
    assert "bf16" in PRECISIONS


@pytest.mark.parametrize("arch", ["tiny", "unet-mini"])
def test_cast_adapter_train_only(clients, arch):
    """train=True computes in bf16; train=False (evaluation) is the f32
    adapter's output exactly."""
    ta = adapters(arch, False)[1]
    bf = cast_adapter(ta, "bf16")
    params = ta.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    batch = {k: torch.from_numpy(v[:4]) for k, v in clients[0].train.items()}
    x = ta.inputs(batch)
    train_out = bf.apply_seg("front", params["front"], x, batch, True)
    assert all(l.dtype == torch.bfloat16 for l in tree_leaves(train_out))
    eval_out = bf.apply_seg("front", params["front"], x, batch, False)
    for a, b in zip(tree_leaves(eval_out), tree_leaves(
            ta.apply_seg("front", params["front"], x, batch, False))):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    spec = bf.boundary_specs({k: v.numpy() for k, v in batch.items()})
    assert all(l.dtype == torch.bfloat16
               for l in tree_leaves(spec["front->middle"]))


@pytest.mark.parametrize("nls", [False, True], ids=["LS", "NLS"])
@pytest.mark.parametrize("method", METHODS)
def test_bf16_masters_stay_fp32(clients, method, nls):
    """Every method of the grid trains in bf16, in both cuts."""
    st, state, logs, m = _train_eval(method, "bf16", clients, epochs=1,
                                     nls=nls)
    for i in range(len(clients)):
        assert all(l.dtype == torch.float32
                   for l in tree_leaves(st.params_for_eval(state, i)))
    opts = [state[k] for k in ("opt", "c_opts", "s_opt") if k in state]
    assert all(l.dtype in (torch.float32, torch.int64)
               for l in tree_leaves(opts))
    assert all(np.isfinite(l.losses).all() for l in logs)
    assert 0.0 <= m["auroc"] <= 1.0


@pytest.mark.parametrize("method", ["fl", "sl_am", "sflv2_ac"])
def test_bf16_auroc_within_tolerance(clients, method):
    """The §13 acceptance gate: |AUROC(bf16) - AUROC(fp32)| <= 0.05, from
    the weights of the reference's case.  At this size (48 test images)
    the gate depends on the start: over the port's own inits of seeds 0-5
    |difference| reads 0.003-0.066 (3 of 18 method-seed pairs above 0.05,
    in both directions), and from the reference's start 0.003-0.018."""
    m32 = _train_eval(method, "fp32", clients)[3]
    m16 = _train_eval(method, "bf16", clients)[3]
    assert abs(m16["auroc"] - m32["auroc"]) <= 0.05, (m16, m32)


@pytest.mark.parametrize("arch, method", [
    ("tiny", "sflv3_ac"), ("tiny", "fl"), ("tiny", "sl_am"),
    ("densenet-mini", "sflv3_ac"), ("unet-mini", "sl_am")])
def test_bf16_first_step_losses_match_the_reference(clients, arch, method):
    """Both packages in bf16 on their compiled engines, from the
    reference's weights and the same batches."""
    ja, ta = adapters(arch, False)
    sj = j_make_strategy(method, ja, lambda: JO.adam(1e-3), 3,
                         precision="bf16")
    st = make_strategy(method, ta, lambda: TO.adam(1e-3), 3,
                       precision="bf16", device="cpu")
    state_j = sj.setup(jax.random.key(0))
    state_t = port_state(method, jax.tree.map(np.asarray, state_j))
    data = [c.train for c in clients]
    _, lj = sj.run_epoch(state_j, data, np.random.default_rng(1), 4)
    _, lt = st.run_epoch(state_t, data, np.random.default_rng(1), 4)
    per_step = len(lj.losses) // lj.steps
    assert (lt.steps, lt.weights) == (lj.steps, lj.weights)
    assert np.isfinite(lt.losses).all()
    np.testing.assert_allclose(lt.losses[:per_step], lj.losses[:per_step],
                               atol=LOSS_TOL, rtol=0)


@pytest.mark.parametrize("codec", ["identity", "int8"])
@pytest.mark.parametrize("method, nls", [("sflv3_ac", False),
                                         ("sl_am", True)])
def test_bf16_wire_bytes_are_the_references(clients, codec, method, nls):
    """The boundary specs inherit the cast, so the activations cross as
    bf16 (int8 rows of bf16 activations under the int8 codec)."""
    ja, ta = adapters("tiny", nls)
    tj, tt = JTransport(codec), Transport(codec, device="cpu")
    sj = j_make_strategy(method, ja, lambda: JO.adam(1e-3), 3,
                         transport=tj, precision="bf16")
    st = make_strategy(method, ta, lambda: TO.adam(1e-3), 3, transport=tt,
                       precision="bf16", device="cpu")
    data = [c.train for c in clients]
    sj.run_epoch(sj.setup(jax.random.key(0)), data,
                 np.random.default_rng(1), 4)
    st.run_epoch(st.setup(0), data, np.random.default_rng(1), 4)
    assert tt.steps == tj.steps > 0
    assert tt.bytes_on_wire == tj.bytes_on_wire
    assert tt.bytes_raw == tj.bytes_raw
    f32 = Transport(codec, device="cpu")
    make_strategy(method, ta, lambda: TO.adam(1e-3), 3, transport=f32,
                  device="cpu").run_epoch(
        st.setup(0), data, np.random.default_rng(1), 4)
    assert tt.bytes_raw * 2 == f32.bytes_raw
