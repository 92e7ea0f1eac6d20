"""The port's privacy module (``repro_torch.privacy``) against ``repro``'s, on
the CPU: cut-layer noise, DP-SGD gradients, the noise streams and the
accountant.

The port draws its noise from ``torch.Generator`` streams, not threefry, so
where the draws matter the reference's draws are fed to the port (the
port's ``_leaf_noise`` monkeypatched to return them) and elsewhere the
draws are held to their statistics.  Tolerances:
  * the noised cut-layer boundary, fused (K4) and unfused (K1, K2 + the
    add): bit-equal to the reference's, and fused == unfused;
  * ``dp_value_and_grad`` (noise 0, C = 1 and 0.05) against the
    reference: loss and gradient within 1e-5 (float32 round-off of
    convolutions and of the clip's sums in another order);
  * the neutral DP path (``force_dp``) against the non-private step: losses
    and params within 1e-5, as ``tests/test_privacy.py`` asks of the
    reference;
  * noise statistics: sample std within 5% of the configured std over
    20,000 draws or more (the sample std's own spread there is 0.5%);
  * epsilon: exactly equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.core.partition import cnn_adapter as j_cnn_adapter
from repro.core.strategies import make_strategy as j_make_strategy
from repro.data.synthetic import make_cxr_clients
from repro.models.cnn import DenseNetConfig as JConfig
from repro.models.cnn import build_densenet as j_build
from repro.privacy import PrivacyConfig as JPrivacy
from repro.privacy import dpsgd as JD
from repro.wire import Transport as JTransport
from repro.wire import make_codec as j_make_codec
from repro_torch import optim as TO
from repro_torch.core.partition import cnn_adapter
from repro_torch.core.strategies import make_strategy
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models.cnn import DenseNetConfig, build_densenet
from repro_torch.privacy import (PrivacyConfig, boundary_with_key,
                                 dp_value_and_grad)
from repro_torch.privacy import dpsgd as TD
from repro_torch.tree import tree_leaves
from repro_torch.wire import Transport, make_codec

torch.set_num_threads(2)

# the reference's own tiny privacy model (tests/test_privacy.py)
TINY = dict(growth=4, blocks=(1, 1), stem_ch=8, cut_layer=1)


def _x(shape, dt, seed=0):
    x = (np.random.default_rng(seed).standard_normal(shape) * 3).astype(
        np.float32)
    td = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dt]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      a.astype(jnp.float32))


# ---------------------------------------------------------------------------
# cut-layer noise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 5, 5, 40), (2, 7, 3, 96)])
def test_cut_noise_boundary_bit_equal_to_repro(monkeypatch, fused, dt,
                                               shape):
    std = 0.7
    xj, xt = _x(shape, dt)
    key = jax.random.key(11)
    zz = np.asarray(JD._leaf_noise(xj, jax.random.fold_in(key, jnp.uint32(0)),
                                   std))
    monkeypatch.setattr(TD, "_leaf_noise",
                        lambda l, gen, s: torch.from_numpy(zz.copy()))
    jt, tt = JTransport("int8", fuse=False), Transport("int8", fuse=False,
                                                       device="cpu")
    out_j = JD.cut_noise_boundary(
        jt.boundary, std, j_make_codec("int8") if fused else None)(xj, key)
    out_t = boundary_with_key(
        tt.boundary, PrivacyConfig(cut_noise_std=std), None,
        make_codec("int8") if fused else None)(xt)
    assert out_t.dtype == xt.dtype
    np.testing.assert_array_equal(_f32(out_j), _f32(out_t))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cut_noise_fused_equals_unfused_with_own_draws(dt):
    _, xt = _x((4, 6, 6, 48), dt, seed=1)
    cfg = PrivacyConfig(cut_noise_std=0.5, seed=3)
    outs = []
    for codec, fuse in [(make_codec("int8"), True), (None, False)]:
        gen = TD.make_generator(cfg, 1, 0, TD.CUT, "cpu")
        tr = Transport("int8", fuse=fuse, device="cpu")
        outs.append(boundary_with_key(tr.boundary, cfg, gen, codec=codec)(xt))
    np.testing.assert_array_equal(_f32(outs[0]), _f32(outs[1]))
    # and the noise is really there
    assert not torch.equal(outs[0], Transport("int8", device="cpu")
                           .boundary(xt))


def test_cut_noise_statistics():
    """On a zero activation the int8 roundtrip is exactly zero, so the
    boundary's output is the noise itself."""
    cfg = PrivacyConfig(cut_noise_std=0.5, seed=0)
    zero = torch.zeros((8, 16, 16, 40))
    gen = TD.make_generator(cfg, 1, 0, TD.CUT, "cpu")
    out = boundary_with_key(None, cfg, gen, codec=make_codec("int8"))(zero)
    assert abs(float(out.std()) / 0.5 - 1) < 0.05
    assert abs(float(out.mean())) < 0.05 * 0.5


def test_streams_repeat_by_seed_and_differ_by_hospital():
    cfg = PrivacyConfig(seed=5)
    draw = lambda *a: torch.randn(  # noqa: E731
        1000, generator=TD.make_generator(cfg, *a, "cpu"))
    assert torch.equal(draw(3, 1, TD.CUT), draw(3, 1, TD.CUT))
    others = [draw(3, 2, TD.CUT), draw(4, 1, TD.CUT), draw(3, 1, TD.DP),
              torch.randn(1000, generator=TD.make_generator(
                  PrivacyConfig(seed=6), 3, 1, TD.CUT, "cpu"))]
    for o in others:
        assert not torch.equal(draw(3, 1, TD.CUT), o)
    seeds = {TD.stream_seed(s, st, h, p) for s in range(3) for st in range(4)
             for h in range(5) for p in (TD.CUT, TD.DP)}
    assert len(seeds) == 3 * 4 * 5 * 2 and max(seeds) < 2 ** 63


# ---------------------------------------------------------------------------
# DP-SGD
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    clients = make_cxr_clients(seed=0, n_clients=3,
                               train_per_client=[8, 4, 6],
                               val_per_client=4, test_per_client=4,
                               image_size=16)
    ja = j_cnn_adapter(j_build(JConfig(**TINY)))
    ta = cnn_adapter(build_densenet(DenseNetConfig(**TINY)))
    return clients, ja, ta


@pytest.mark.parametrize("clip", [1.0, 0.05])
def test_dp_value_and_grad_matches_repro(tiny, clip):
    """C = 1 clips some examples; C = 0.05 clips every one."""
    clients, ja, ta = tiny
    pj = ja.init(jax.random.key(0))
    batch = {k: v[:4] for k, v in clients[0].train.items()}
    lj, gj = jax.jit(JD.dp_value_and_grad(
        JD.keyed(ja.full_loss), JPrivacy(clip_norm=clip)))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    pt = params_from_jax(jax.tree.map(np.asarray, pj))
    lt, gt = dp_value_and_grad(
        lambda p, b, e: ta.full_loss(p, b), PrivacyConfig(clip_norm=clip))(
        pt, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(lt), float(lj), atol=1e-5, rtol=0)
    flat_j = jax.tree.leaves(jax.tree.map(np.asarray, gj))
    flat_t = jax.tree.leaves(params_to_numpy(gt))
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


def test_dp_noise_statistics(tiny):
    """With a zero gradient the summed gradient is the noise alone: its
    sample std is sigma * C (the mean divides it by B)."""
    sigma, clip, b = 1.5, 0.8, 2
    params = {"w": torch.ones((20000,))}
    fn = dp_value_and_grad(lambda p, bt, e: (p["w"] * 0.0).sum() + bt["x"].sum(),
                           PrivacyConfig(noise_multiplier=sigma,
                                         clip_norm=clip))
    _, g = fn(params, {"x": torch.zeros((b, 3))},
              torch.Generator().manual_seed(0))
    assert abs(float((g["w"] * b).std()) / (sigma * clip) - 1) < 0.05


def test_neutral_dp_equals_nonprivate(tiny):
    clients, _, ta = tiny
    out = []
    for priv in (None, PrivacyConfig(noise_multiplier=0.0,
                                     clip_norm=math.inf, force_dp=True)):
        st = make_strategy("sflv3_ac", ta, lambda: TO.adam(1e-3), 3,
                           privacy=priv, device="cpu")
        state = st.setup(0)
        state, log = st.run_epoch(state, [c.train for c in clients],
                                  np.random.default_rng(0), 2)
        out.append((log, state))
    (la, sa), (lb, sb) = out
    assert la.steps == lb.steps == 4
    np.testing.assert_allclose(lb.losses, la.losses, atol=1e-5, rtol=0)
    for a, b in zip(tree_leaves([sa["clients"], sa["server"]]),
                    tree_leaves([sb["clients"], sb["server"]])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=0)


def test_privacy_report_equals_repro_epsilon(tiny):
    """One epoch of unequal hospitals (8, 4, 6 images, batch 2: the short
    ones wrap around) accounts exactly the reference's epsilon."""
    clients, ja, ta = tiny
    data = [c.train for c in clients]
    sj = j_make_strategy("sflv3_ac", ja, lambda: JO.adam(1e-3), 3,
                         engine="stepwise",
                         privacy=JPrivacy(noise_multiplier=1.0,
                                          clip_norm=1.0))
    sj.run_epoch(sj.setup(jax.random.key(0)), data,
                 np.random.default_rng(0), 2)
    st = make_strategy("sflv3_ac", ta, lambda: TO.adam(1e-3), 3,
                       privacy=PrivacyConfig(noise_multiplier=1.0,
                                             clip_norm=1.0,
                                             cut_noise_std=0.3),
                       device="cpu")
    state, log = st.run_epoch(st.setup(0), data, np.random.default_rng(0), 2)
    assert np.isfinite(log.losses).all()
    rj, rt = sj.privacy_report(), st.privacy_report()
    assert len(rt) == 3 and rt == rj
    assert all(0 < r["epsilon"] < math.inf and r["steps"] == 4 for r in rt)


def test_private_options_raise_as_in_repro(tiny):
    _, _, ta = tiny
    with pytest.raises(ValueError, match="secure aggregation"):
        make_strategy("sflv3_ac", ta, lambda: TO.adam(1e-3), 3,
                      privacy=PrivacyConfig(secagg=True), device="cpu")
    with pytest.raises(ValueError, match="unbounded"):
        PrivacyConfig(noise_multiplier=1.0)
    assert not PrivacyConfig().any_enabled
    assert PrivacyConfig(cut_noise_std=0.1).any_enabled
    assert not PrivacyConfig(cut_noise_std=0.1).dp_enabled
