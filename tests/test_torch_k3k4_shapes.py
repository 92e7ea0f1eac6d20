"""K3 (fused int8 roundtrip) and K4 (roundtrip + row-weighted cut noise)
at the widths and values that ``chip_smoke.py`` phase 3 holds the CUDA
kernels to, on the CPU, and their launch plans.

Phase 3 holds K3 and K4 bit-equal to ``roundtrip_ref`` and
``noise_roundtrip_ref`` on the card, so those must themselves be the
reference's at exactly those inputs: the same numpy-seeded rows go through
``repro.kernels.cut_fuse.cut_fuse``'s ``roundtrip_pallas`` and
``noise_roundtrip_pallas`` (called directly, in interpret mode: K4 takes
one weight a row, which the reference's ops wrapper does not expose) and
through ``repro_torch``'s wrappers (on the CPU, the plain versions), in
f32 and bf16, at the vector path's and the general path's widths, with
every third row zero, and with rows whose every x / scale but one is an
exact .5 tie; K4's row weights mix ones, 0/1 masks and fractions.
Tolerance: none, the outputs are bit-equal.  ``roundtrip_plan`` and
``noise_roundtrip_plan`` are the wrappers' choice of path, which this file
holds to ``vector_plan``'s rules.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cut_fuse.cut_fuse import (noise_roundtrip_pallas,
                                             roundtrip_pallas)
from repro_torch.kernels.act_compress import act_compress as AC
from repro_torch.kernels.cut_fuse import cut_fuse as CF

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ROWS = 37
# chip_smoke.VECTOR_D and GENERAL_D: every width the main path hands K3
# and K4, and ragged ones
VECTOR_D = (160, 64, 128, 256, 512, 576, 728, 768)
GENERAL_D = (1, 3, 33, 161)


def _gauss(rng, d):
    return rng.standard_normal((ROWS, d)) * 3


def _zero_rows(rng, d):
    x = rng.standard_normal((ROWS, d)) * 3
    x[::3] = 0
    return x


def _ties(rng, d):
    """One +-127 * 2^e a row (its scale is then exactly 2^e), the rest
    (k + 0.5) * 2^e: exact in f32 and bf16, every quotient a tie."""
    v = rng.integers(-127, 127, (ROWS, d)) + 0.5
    v[:, 0] = np.where(rng.random(ROWS) < 0.5, -127.0, 127.0)
    return v * np.exp2(np.arange(ROWS) % 9 - 4)[:, None]


def _weights(rng):
    """Row weights: ones, 0/1 masks and fractions, a third each."""
    w = rng.random((ROWS, 1))
    w[0::3] = 1.0
    w[1::3] = rng.random((len(w[1::3]), 1)) < 0.6
    return w.astype(np.float32)


CASES = [("gauss", d) for d in VECTOR_D + GENERAL_D]
CASES += [(kind, d) for kind in ("zero_rows", "ties") for d in (160, 728, 161)]
MAKE = {"gauss": _gauss, "zero_rows": _zero_rows, "ties": _ties}
IDS = [f"{k}-{d}" for k, d in CASES]


def _inputs(kind, d):
    rng = np.random.default_rng(d)
    x = MAKE[kind](rng, d).astype(np.float32)
    z = (rng.standard_normal((ROWS, d)) * 0.5).astype(np.float32)
    return x, z, _weights(rng)


@pytest.mark.parametrize("kind,d", CASES, ids=IDS)
@pytest.mark.parametrize("dt", DTYPES)
def test_roundtrip_ref_equals_roundtrip_pallas(kind, d, dt):
    x, _, _ = _inputs(kind, d)
    jd, td = DTYPES[dt]
    want = roundtrip_pallas(jnp.asarray(x).astype(jd), interpret=True)
    got = CF.roundtrip_rows(torch.from_numpy(x).to(td))
    assert got.dtype == td
    np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)),
                                  got.float().numpy())
    if kind == "zero_rows":
        assert not got[::3].any()


@pytest.mark.parametrize("kind,d", CASES, ids=IDS)
@pytest.mark.parametrize("dt", DTYPES)
def test_noise_roundtrip_ref_equals_noise_roundtrip_pallas(kind, d, dt):
    x, z, w = _inputs(kind, d)
    assert {1.0, 0.0} <= set(w.ravel()) and ((w > 0) & (w < 1)).any()
    jd, td = DTYPES[dt]
    want = noise_roundtrip_pallas(jnp.asarray(x).astype(jd), jnp.asarray(z),
                                  jnp.asarray(w), interpret=True)
    got = CF.noise_roundtrip_rows(torch.from_numpy(x).to(td),
                                  torch.from_numpy(z), torch.from_numpy(w))
    assert got.dtype == td
    np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)),
                                  got.float().numpy())


PER = [(torch.float32, 4), (torch.bfloat16, 8)]


@pytest.mark.parametrize("dtype,per", PER)
def test_k3_k4_take_k1s_plans_at_aligned_pointers(dtype, per):
    """At aligned pointers K3 and K4 take exactly K1's plan (which
    ``test_torch_k1_shapes.py`` pins): the fewest idle vector slots, up to
    32 x MAX_VECS vectors a row."""
    for d in range(1, 32 * AC.MAX_VECS * per + 2 * per):
        plan = AC.quantize_plan(d, dtype, 0, 0)
        assert CF.roundtrip_plan(d, dtype, 0, 0) == plan, d
        assert CF.noise_roundtrip_plan(d, dtype, 0, 0, 0) == plan, d
        if plan is None:
            assert d % per or d // per > 32 * AC.MAX_VECS, d
            continue
        g, v = plan
        n = d // per
        fits = [(h, -(-n // h)) for h in (1, 2, 4, 8, 16, 32)
                if -(-n // h) <= AC.MAX_VECS]
        assert g * v == min(h * u for h, u in fits), (d, plan)


@pytest.mark.parametrize("dtype,per", PER)
def test_k3_k4_plans_need_each_operand_on_16_bytes(dtype, per):
    ok = CF.roundtrip_plan(160, dtype, 16, 32)
    assert ok is not None
    assert CF.noise_roundtrip_plan(160, dtype, 16, 48, 32) == ok
    for bad in (4, 8, 24):
        assert CF.roundtrip_plan(160, dtype, bad, 0) is None       # x
        assert CF.roundtrip_plan(160, dtype, 0, bad) is None       # out
        assert CF.noise_roundtrip_plan(160, dtype, bad, 0, 0) is None
        assert CF.noise_roundtrip_plan(160, dtype, 0, bad, 0) is None  # z
        assert CF.noise_roundtrip_plan(160, dtype, 0, 0, bad) is None
    # K1 needs q only on one vector's levels; K3's out needs 16 bytes
    assert AC.quantize_plan(160, dtype, 0, per) == ok
    assert CF.roundtrip_plan(160, dtype, 0, per) is None


@pytest.mark.parametrize("d,dtype,plan", [
    (160, torch.float32, (8, 5)), (160, torch.bfloat16, (4, 5)),
    (64, torch.float32, (4, 4)), (64, torch.bfloat16, (2, 4)),
    (128, torch.float32, (8, 4)), (128, torch.bfloat16, (4, 4)),
    (256, torch.float32, (16, 4)), (256, torch.bfloat16, (8, 4)),
    (512, torch.float32, (32, 4)), (512, torch.bfloat16, (16, 4)),
    (576, torch.float32, (32, 5)), (576, torch.bfloat16, (16, 5)),
    (728, torch.float32, (32, 6)), (728, torch.bfloat16, (32, 3)),
    (768, torch.float32, (32, 6)), (768, torch.bfloat16, (32, 3))])
def test_every_main_path_width_takes_the_vector_path(d, dtype, plan):
    assert CF.roundtrip_plan(d, dtype, 0, 0) == plan
    assert CF.noise_roundtrip_plan(d, dtype, 0, 0, 0) == plan


def test_args_pass_the_plan_or_the_general_path():
    x = torch.zeros((5, 160), dtype=torch.bfloat16)
    z = torch.zeros((5, 160))
    w = torch.ones((5, 1))
    out = torch.empty_like(x)
    plan = CF.roundtrip_plan(160, x.dtype, x.data_ptr(), out.data_ptr())
    assert plan is not None
    assert CF.roundtrip_args(x, out)[2:] == (5, 160, 1, *plan)
    assert CF.noise_roundtrip_args(x, z, w, out)[4:] == (5, 160, 1, *plan)
    view = torch.zeros(5 * 160 + 1, dtype=torch.bfloat16)[1:].view(5, 160)
    assert CF.roundtrip_args(view, out)[2:] == (5, 160, 1, 1, 0)
    zview = torch.zeros(5 * 160 + 1)[1:].view(5, 160)
    assert CF.noise_roundtrip_args(x, zview, w, out)[4:] == (5, 160, 1, 1, 0)
