"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` on the CPU, f32.

Params are drawn by the port and converted (``lm_params_to_numpy``);
inputs are numpy-seeded.  Cases: a token count that is a multiple of the
chunk and one that is not (the zero padding rows tie every expert, so the
tie-break decides ``lb_loss``), a single short chunk, Kimi K2's SMOKE
layer (top-2 with a shared expert), and capacities that drop tokens.
Tolerances: outputs within 1e-5 of their largest magnitude, ``lb_loss``
and ``z_loss`` within 1e-5 relative, ``dropped`` within 1e-6 relative
(a share of whole (token, slot) pairs: the same drops, a mean rounded
another way);
gradients of a weighted sum of the output and both losses within 1e-4 of
each leaf's largest magnitude (float32 round-off of other summation
orders through the softmax and five products).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import kimi_k2_1t_a32b as JK
from repro.models import moe as JMOE
from repro_torch.interop import lm_params_to_numpy
from repro_torch.models import moe as TMOE
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

CPU = torch.device("cpu")
KIMI = JK.SMOKE
CASES = {
    # name: (B, S, config)
    "whole_chunks": (2, 32, dict(d_model=32, d_ff=16, n_experts=4, top_k=2,
                                 chunk=16)),
    "padded_chunk": (3, 10, dict(d_model=32, d_ff=16, n_experts=4, top_k=2,
                                 chunk=8)),
    "one_short_chunk": (1, 12, dict(d_model=32, d_ff=24, n_experts=6,
                                    top_k=1, chunk=64)),
    "kimi_top2_shared": (2, 40, dict(
        d_model=KIMI.d_model, d_ff=KIMI.d_ff, n_experts=KIMI.n_experts,
        top_k=KIMI.top_k, capacity_factor=KIMI.capacity_factor,
        chunk=KIMI.moe_chunk, n_shared_experts=KIMI.n_shared_experts)),
    "drops_top1": (2, 24, dict(d_model=32, d_ff=16, n_experts=4, top_k=1,
                               chunk=16, capacity_factor=0.5)),
    "drops_top2_padded": (1, 21, dict(d_model=16, d_ff=8, n_experts=8,
                                      top_k=2, chunk=8,
                                      capacity_factor=0.6)),
}


def _pair(name, seed=0):
    b, s, kw = CASES[name]
    tc = TMOE.MoEConfig(**kw)
    jc = JMOE.MoEConfig(**kw)
    pt = TMOE.moe_init(torch.Generator().manual_seed(seed), tc, CPU)
    pj = jax.tree.map(jnp.asarray, lm_params_to_numpy(pt))
    x = np.random.default_rng(seed + 1).normal(
        size=(b, s, kw["d_model"])).astype(np.float32)
    return jc, tc, pj, pt, x


def test_top_k_ties_go_to_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.1, 0.3, 0.3]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = TMOE.top_k_lower_index(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("name", list(CASES))
def test_moe_apply_matches_reference(name):
    jc, tc, pj, pt, x = _pair(name)
    yj, aj = JMOE.moe_apply(pj, jc, jnp.asarray(x))
    yt, at = TMOE.moe_apply(pt, tc, torch.from_numpy(x))
    yj = np.asarray(yj)
    assert yt.shape == yj.shape and yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                               atol=1e-5 * np.abs(yj).max())
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=1e-5)
    np.testing.assert_allclose(float(at["dropped"]), float(aj["dropped"]),
                               rtol=1e-6)
    if name.startswith("drops"):
        assert float(at["dropped"]) > 0


def test_padding_rows_take_the_lowest_experts():
    """A zero row has uniform probabilities; its top-k is experts 0..k-1,
    so the padded chunk's routed share ``ce`` counts them there."""
    jc, tc, pj, pt, _ = _pair("padded_chunk")
    x = torch.zeros((1, 8, tc.d_model))
    _, idx = TMOE.top_k_lower_index(torch.softmax(
        x.reshape(8, -1) @ pt["router"], -1), tc.top_k)
    assert idx.tolist() == [[0, 1]] * 8
    _, aj = JMOE.moe_apply(pj, jc, jnp.asarray(x.numpy()))
    _, at = TMOE.moe_apply(pt, tc, x)
    assert float(at["lb_loss"]) == pytest.approx(float(aj["lb_loss"]),
                                                 rel=1e-6)


@pytest.mark.parametrize("name", ["padded_chunk", "kimi_top2_shared",
                                  "drops_top1"])
def test_moe_gradients_match_reference(name):
    jc, tc, pj, pt, x = _pair(name, seed=3)
    w = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = JMOE.moe_apply(p, jc, xx)
        return (y * w).sum() + aux["lb_loss"] + aux["z_loss"]

    gpj, gxj = jax.grad(jloss, argnums=(0, 1))(pj, jnp.asarray(x))
    p = jax.tree.map(lambda t: t.clone().requires_grad_(True), pt)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = TMOE.moe_apply(p, tc, xt)
    ((y * torch.from_numpy(w)).sum() + aux["lb_loss"]
     + aux["z_loss"]).backward()
    got = lm_params_to_numpy(jax.tree.map(lambda t: t.grad, p))
    pairs = list(zip(jax.tree.leaves(gpj), jax.tree.leaves(got)))
    pairs.append((gxj, xt.grad.numpy()))
    for want, have in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(have, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    assert len(tree_leaves(pt)) == len(jax.tree.leaves(gpj))


def test_bf16_inputs_stay_bf16():
    """bf16 compute (the configs' default): the expert products run in
    bf16, the router in f32, and the output is bf16 near the reference's
    (0.05 of the largest magnitude: a few bf16 ulps through three
    products)."""
    jc, tc, pj, pt, x = _pair("whole_chunks")
    yj, _ = JMOE.moe_apply(pj, jc, jnp.asarray(x, jnp.bfloat16))
    yt, at = TMOE.moe_apply(pt, tc, torch.from_numpy(x).to(torch.bfloat16))
    assert yt.dtype == torch.bfloat16 and at["lb_loss"].dtype == torch.float32
    yj = np.asarray(yj, np.float32)
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=0,
                               atol=0.05 * np.abs(yj).max())


def test_config_fields_match_reference():
    assert [f.name for f in dataclasses.fields(TMOE.MoEConfig)] == [
        f.name for f in dataclasses.fields(JMOE.MoEConfig)]
    for t in (5, 64, 512):
        for kw in (CASES["kimi_top2_shared"][2], CASES["drops_top1"][2]):
            assert TMOE.capacity(t, TMOE.MoEConfig(**kw)) == \
                JMOE._capacity(t, JMOE.MoEConfig(**kw))
