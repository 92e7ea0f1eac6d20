"""LM training in the port (``repro_torch.launch.train``) against
``repro.launch.train`` on the CPU, f32 compute: one case per model kind
(dense, MoE top-1, MoE top-2 with ``first_k_dense`` and a shared expert,
the hybrid with its shared block, the vision and audio frontends, the
SSM), each the gradients of ``loss`` and the params after two steps of
``make_plain_train_step`` under Adam.

Params are drawn by the port and converted (``lm_params_to_numpy``);
tokens and frontend embeddings are numpy-seeded; the reference runs
under ``jax.jit``.  Tolerances:
  * gradients within 5e-5 of each leaf's largest magnitude (float32
    round-off of other summation orders through the layers and their
    backward; the hybrid's SSD reaches 2e-5);
  * losses within 1e-5;
  * params after two Adam steps within 1e-5 absolute.  The Adam of these
    cases has ``eps = 1e-3``: its update is then Lipschitz in the gradient
    (``lr / eps = 1``), where the default 1e-8 would turn a 1e-9 gradient
    difference around zero into a whole ``lr`` step.
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
from repro_torch.interop import lm_params_to_numpy
from repro_torch.launch import train as TT
from repro_torch.models.transformer import TransformerLM
from repro_torch.tree import tree_map

torch.set_num_threads(2)

KINDS = {"dense": "smollm-135m", "moe_top1": "llama4-scout-17b-a16e",
         "moe_top2_first_dense": "kimi-k2-1t-a32b", "hybrid": "zamba2-7b",
         "vlm": "internvl2-76b", "audio": "musicgen-medium",
         "ssm": "mamba2-130m"}
LR, EPS = 1e-3, 1e-3


def _pair(arch):
    jc = dataclasses.replace(JR.get(arch).smoke, compute_dtype=jnp.float32)
    tc = dataclasses.replace(TR.get(arch).smoke, compute_dtype=torch.float32)
    jm, tm = JLM.build(jc), TransformerLM.build(tc)
    pt = tm.init_params(torch.Generator().manual_seed(0), "cpu")
    pj = jax.tree.map(jnp.asarray, lm_params_to_numpy(pt))
    return jm, tm, pj, pt


def _batch(cfg, n=2, seq=41, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (n, seq)).astype(
        np.int32)}
    if cfg.frontend is not None:
        b["frontend_emb"] = rng.normal(
            size=(n, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                np.float32)
    return (jax.tree.map(jnp.asarray, b),
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close(have, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(have), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("kind", list(KINDS))
def test_gradients_and_two_adam_steps_match_reference(kind):
    jm, tm, pj, pt = _pair(KINDS[kind])
    jb, tb = _batch(tm.cfg)
    gj = jax.jit(jax.grad(lambda p: jm.loss(p, jb)))(pj)
    p = tree_map(lambda t: t.clone().requires_grad_(True), pt)
    tm.loss(p, tb).backward()
    gt = lm_params_to_numpy(tree_map(lambda t: t.grad, p))
    for a, b in zip(jax.tree.leaves(gj), jax.tree.leaves(gt)):
        _close(b, a, 5e-5)
    jopt, topt = JO.adam(LR, eps=EPS), TO.adam(LR, eps=EPS)
    jstep = jax.jit(JT.make_plain_train_step(jm, jopt))
    tstep = TT.make_plain_train_step(tm, topt)
    jp, js, tp, ts = pj, jopt.init(pj), pt, topt.init(pt)
    for _ in range(2):
        jp, js, jl = jstep(jp, js, jb)
        tp, ts, tl = tstep(tp, ts, tb)
        assert abs(float(tl) - float(jl)) <= 1e-5
        assert not tl.requires_grad
    assert int(ts["step"]) == 2
    for a, b in zip(jax.tree.leaves(jp),
                    jax.tree.leaves(lm_params_to_numpy(tp))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5)
    # the step moved every param tree it trains
    assert any(not torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(tp), jax.tree.leaves(pt)))


def test_plain_step_leaves_unused_padding_rows_alone():
    """A padded vocabulary's padding rows get zero gradients (the
    reference's), so Adam leaves them where they were."""
    tc = dataclasses.replace(TR.get("minicpm-2b").smoke,
                             compute_dtype=torch.float32, vocab_pad_to=128)
    tm = TransformerLM.build(tc)
    pt = tm.init_params(torch.Generator().manual_seed(0), "cpu")
    opt = TO.adam(LR)
    step = TT.make_plain_train_step(tm, opt)
    _, tb = _batch(tc)
    p, _, loss = step(pt, opt.init(pt), tb)
    assert bool(torch.isfinite(loss))
    pad = slice(tc.vocab_size, tc.padded_vocab)
    assert torch.equal(p["front"]["embed"]["table"][pad],
                       pt["front"]["embed"]["table"][pad])
