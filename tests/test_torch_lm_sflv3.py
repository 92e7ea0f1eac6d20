"""SplitFedv3 LM training in the port (``launch.train.init_sflv3_params``
and ``make_sflv3_train_step``, with and without the int8 link) against
``repro.launch.train`` on the CPU, 3 hospitals, f32 compute, and the
interop of the reference's SFLv3 tree and Adam state.

Cases: SmolLM's SMOKE (dense; the middle runs once on all hospitals'
rows), Llama-4 Scout's (MoE; each hospital's 64 tokens fill whole
dispatch chunks, so the joint middle is exact), Kimi K2's (MoE; 40 tokens
a hospital, fewer than a chunk: the middle runs hospital by hospital) and
Zamba2's (hybrid).  Params are drawn by the port and converted; tokens
are numpy-seeded; the reference runs under ``jax.jit``.  Tolerances:
  * losses within 1e-5 (f32) and 1e-4 with the int8 link (a cut element
    within round-off of a half level lands on the neighbouring level, one
    row scale away, which moves the loss by far less);
  * gradients of the step's loss within 5e-5 of each leaf's largest
    magnitude without the link;
  * params after two Adam steps (``eps = 1e-3``, so the update is
    Lipschitz in the gradient: ``tests/test_torch_lm_train.py``) within
    3e-5 without the link (the hybrid's gradients agree to 2e-5 of their
    scale, and ``lr / eps = 1`` carries that into the params) and 1e-4
    with it;
  * the carried state equal to the reference's bit for bit.
  * the 1/C scaling: each front's gradient equals 1/C of the gradient of
    its own hospital's ``model.loss`` alone, and the middle's the mean
    over hospitals of theirs, within 1e-5 of each leaf's largest
    magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.configs import registry as JR
from repro.launch import train as JT
from repro.models.transformer import TransformerLM as JLM
from repro_torch import optim as TO
from repro_torch.configs import registry as TR
from repro_torch.interop import lm_params_to_numpy, lm_sflv3_from_jax
from repro_torch.launch import train as TT
from repro_torch.models.transformer import TransformerLM
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

C = 3
LR, EPS = 1e-3, 1e-3
CASES = {"dense": ("smollm-135m", 33), "moe_joint": (
    "llama4-scout-17b-a16e", 33), "moe_per_hospital": ("kimi-k2-1t-a32b", 21),
    "hybrid": ("zamba2-7b", 17)}


def _pair(arch):
    jc = dataclasses.replace(JR.get(arch).smoke, compute_dtype=jnp.float32)
    tc = dataclasses.replace(TR.get(arch).smoke, compute_dtype=torch.float32)
    jm, tm = JLM.build(jc), TransformerLM.build(tc)
    pt = TT.init_sflv3_params(tm, torch.Generator().manual_seed(0), C, "cpu")
    pj = jax.tree.map(jnp.asarray, lm_params_to_numpy(pt))
    return jm, tm, pj, pt


def _batch(cfg, seq, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (C * 2, seq)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def _close(have, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(have), want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_init_keeps_the_stacked_layout():
    jm, tm, pj, pt = _pair("smollm-135m")
    want = jax.eval_shape(lambda k: JT.init_sflv3_params(jm, k, C)[0],
                          jax.random.key(0))
    assert [l.shape for l in jax.tree.leaves(want)] == [
        l.shape for l in jax.tree.leaves(lm_params_to_numpy(pt))]
    # each hospital's front drawn on its own
    emb = pt["fronts"]["embed"]["table"]
    assert emb.shape[0] == C and not torch.equal(emb[0], emb[1])
    with pytest.raises(ValueError, match="nls"):
        TT.init_sflv3_params(TransformerLM.build(tm.cfg, nls=True),
                             torch.Generator(), C, "cpu")


@pytest.mark.parametrize("compress", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("case", list(CASES))
def test_sflv3_step_matches_reference(case, compress):
    arch, seq = CASES[case]
    jm, tm, pj, pt = _pair(arch)
    jb, tb = _batch(tm.cfg, seq)
    jopt, topt = JO.adam(LR, eps=EPS), TO.adam(LR, eps=EPS)
    jstep = jax.jit(JT.make_sflv3_train_step(jm, jopt, C, compress))
    tstep = TT.make_sflv3_train_step(tm, topt, C, compress)
    jp, js, tp, ts = pj, jopt.init(pj), pt, topt.init(pt)
    loss_bar, param_bar = (1e-4, 1e-4) if compress else (1e-5, 3e-5)
    for _ in range(2):
        jp, js, jl = jstep(jp, js, jb)
        tp, ts, tl = tstep(tp, ts, tb)
        assert abs(float(tl) - float(jl)) <= loss_bar
    for a, b in zip(jax.tree.leaves(jp),
                    jax.tree.leaves(lm_params_to_numpy(tp))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=param_bar)


@pytest.mark.parametrize("case", ["dense", "moe_per_hospital"])
def test_fronts_carry_one_over_c(case):
    """The step's gradients: the reference's, and each front's 1/C of its
    own hospital's ``model.loss`` gradient, the middle's their mean."""
    arch, seq = CASES[case]
    jm, tm, pj, pt = _pair(arch)
    jb, tb = _batch(tm.cfg, seq)
    seen = {}

    def opt_update(grads, state, params=None):
        seen["g"] = grads
        return tree_map(torch.zeros_like, grads), state
    TT.make_sflv3_train_step(tm, TO.Optimizer(lambda p: {}, opt_update),
                             C)(pt, {}, tb)
    g = seen["g"]
    spy = {}

    def j_update(grads, state, params=None):
        spy["g"] = grads
        return jax.tree.map(jnp.zeros_like, grads), state
    JT.make_sflv3_train_step(jm, JO.Optimizer(lambda p: {}, j_update), C)(
        pj, {}, jb)
    for a, b in zip(jax.tree.leaves(spy["g"]),
                    jax.tree.leaves(lm_params_to_numpy(g))):
        _close(b, a, 5e-5)
    mids = []
    for c in range(C):
        p = {"front": tree_map(lambda x: x[c].clone().requires_grad_(True),
                               pt["fronts"]),
             "middle": tree_map(lambda x: x.clone().requires_grad_(True),
                                pt["middle"])}
        tm.loss(p, {"tokens": tb["tokens"][2 * c:2 * c + 2]}).backward()
        for own, step in zip(tree_leaves(p["front"]),
                             tree_leaves(g["fronts"])):
            _close(step[c].numpy(), own.grad.numpy() / C, 1e-5)
        mids.append([l.grad for l in tree_leaves(p["middle"])])
    for i, step in enumerate(tree_leaves(g["middle"])):
        _close(step.numpy(), (sum(m[i] for m in mids) / C).numpy(), 1e-5)


def test_reference_state_carries_across():
    """The reference's SFLv3 tree and Adam state after one step, carried
    to the port (``lm_sflv3_from_jax``), take the same second step."""
    jm, tm, _, _ = _pair("smollm-135m")
    jb, tb = _batch(tm.cfg, 33)
    pj, _ = JT.init_sflv3_params(jm, jax.random.key(3), C)
    jopt = JO.adam(LR, eps=EPS)
    jstep = jax.jit(JT.make_sflv3_train_step(jm, jopt, C, True))
    pj, js, _ = jstep(pj, jopt.init(pj), jb)
    tp, ts = lm_sflv3_from_jax(jax.tree.map(np.asarray, pj),
                               jax.tree.map(np.asarray, js), "cpu")
    assert int(ts["step"]) == 1 and ts["step"].dtype == torch.int64
    for a, b in zip(jax.tree.leaves((pj, js["mu"], js["nu"])),
                    jax.tree.leaves(lm_params_to_numpy(
                        (tp, ts["mu"], ts["nu"])))):
        np.testing.assert_array_equal(b, np.asarray(a))
    pj, js, jl = jstep(pj, js, jb)
    topt = TO.adam(LR, eps=EPS)
    tp, ts, tl = TT.make_sflv3_train_step(tm, topt, C, True)(tp, ts, tb)
    assert abs(float(tl) - float(jl)) <= 1e-4 and int(ts["step"]) == 2
    for a, b in zip(jax.tree.leaves(pj),
                    jax.tree.leaves(lm_params_to_numpy(tp))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-4)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = TransformerLM.build(TR.get("smollm-135m").smoke)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_sflv3_params(tm, torch.Generator(), C)


def test_example_trains_on_the_cpu(tmp_path):
    """``examples/train_lm_splitfed_torch.py``: a few steps of the quick LM
    on 4 hospitals, the loss falling, the checkpoint loading back."""
    import importlib.util
    from pathlib import Path

    from repro_torch.train import checkpoint
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "train_lm_splitfed_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_example", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    ckpt = tmp_path / "lm.msgpack"
    params, losses = ex.main(["--steps", "12", "--batch", "2", "--seq",
                              "32", "--device", "cpu", "--ckpt", str(ckpt)])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    back = checkpoint.load(str(ckpt), params)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)
