"""K2 (int8 dequantize) at the widths and values that ``chip_smoke.py``
phase 3 holds the CUDA kernel to, on the CPU, and K2's launch plan.

Phase 3 holds K2 bit-equal to ``dequantize_ref`` on the card, so
``dequantize_ref`` must itself be the reference's at exactly those inputs:
the levels and scales that ``quantize_ref`` makes of numpy-seeded rows go
through ``repro.kernels.act_compress.ops.dequantize`` (Pallas in interpret
mode) and ``repro_torch``'s ``ops.dequantize`` (on the CPU,
``dequantize_ref``), into f32 and bf16, at the vector path's and the
general path's widths, with all-zero rows, and with rows of +-127 levels
under scales from the smallest K1 gives (``MIN_AMAX * INV_127``) to 2^20.
Tolerance: none, the outputs are bit-equal.  ``torch.mul(q, s, out=out)``,
the one PyTorch call phase 3 times beside K2, is held bit-equal to
``dequantize_ref`` too.  ``dequantize_plan`` is the wrapper's choice of
K2's path, which this file holds to its rules and to the plans measured
fastest on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.act_compress import ops as JA
from repro_torch.kernels.act_compress import act_compress as AC
from repro_torch.kernels.act_compress import ops as TA
from repro_torch.kernels.act_compress import ref as R

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ROWS = 37
WIDTHS = (1, 3, 33, 64, 161, 576, 728, 1024)
TINY = float(np.float32(R.MIN_AMAX) * np.float32(R.INV_127))


def _gauss(rng, d):
    """K1's levels and scales of Gaussian rows."""
    return R.quantize_ref(torch.from_numpy(
        (rng.standard_normal((ROWS, d)) * 3).astype(np.float32)))


def _zero_rows(rng, d):
    """The same, every third row zero (its levels zero, its scale TINY)."""
    x = rng.standard_normal((ROWS, d)) * 3
    x[::3] = 0
    return R.quantize_ref(torch.from_numpy(x.astype(np.float32)))


def _extremes(rng, d):
    """Every row holds +127 and -127 (the others drawn in [-127, 127])
    under scales spread log-uniformly from TINY (row 0) to 2^20 (the
    last)."""
    q = rng.integers(-127, 128, (ROWS, d))
    q[:, 0], q[:, -1] = 127, -127
    s = np.exp2(np.linspace(np.log2(TINY), 20, ROWS))[:, None]
    s[0], s[-1] = TINY, 2.0 ** 20
    return (torch.from_numpy(q.astype(np.int8)),
            torch.from_numpy(s.astype(np.float32)))


MAKE = {"gauss": _gauss, "zero_rows": _zero_rows, "extremes": _extremes}
CASES = [(kind, d) for kind in MAKE for d in WIDTHS]


def _levels(kind, d):
    return MAKE[kind](np.random.default_rng(d), d)


@pytest.mark.parametrize("kind,d", CASES, ids=[f"{k}-{d}" for k, d in CASES])
@pytest.mark.parametrize("dt", DTYPES)
def test_dequantize_ref_equals_repro_at_phase3_cases(kind, d, dt):
    q, s = _levels(kind, d)
    jd, td = DTYPES[dt]
    want = np.asarray(JA.dequantize(jnp.asarray(q.numpy()),
                                    jnp.asarray(s.numpy()), jd)
                      .astype(jnp.float32))
    got = TA.dequantize(q, s, td)
    assert got.dtype == td
    np.testing.assert_array_equal(want, got.float().numpy())
    if kind == "zero_rows":
        assert not got[::3].any()
    if kind == "extremes":
        # the case is what it says: +-127 in every row (only -127 at
        # D = 1), under TINY and 2^20
        assert (q[:, -1] == -127).all() and (d == 1 or (q[:, 0] == 127).all())
        assert s[0, 0].item() == TINY and s[-1, 0].item() == 2.0 ** 20


@pytest.mark.parametrize("kind,d", CASES, ids=[f"{k}-{d}" for k, d in CASES])
@pytest.mark.parametrize("dt", DTYPES)
def test_torch_mul_equals_dequantize_ref(kind, d, dt):
    """The library yardstick phase 3 times: an int8 (T, D) times an f32
    (T, 1) promotes to f32 and is rounded once into ``out``'s dtype."""
    q, s = _levels(kind, d)
    td = DTYPES[dt][1]
    out = torch.empty((ROWS, d), dtype=td)
    torch.mul(q, s, out=out)
    assert torch.equal(out, R.dequantize_ref(q, s, td))


@pytest.mark.parametrize("dtype,per", [(torch.float32, 4),
                                       (torch.bfloat16, 8)])
def test_dequantize_plan_takes_the_vector_path_only_where_it_can(dtype,
                                                                  per):
    for d in range(1, 40 * per):
        plan = AC.dequantize_plan(d, dtype, 0, 0)
        if d % per or d // per > 32 * AC.MAX_VECS:
            assert plan is None, d
            continue
        assert plan in AC.vector_plans(d, dtype), (d, plan)
        g, v = plan
        assert g in (1, 2, 4, 8, 16, 32) and 1 <= v <= AC.MAX_VECS
        # v is the fewest vectors a lane that cover the row
        assert (v - 1) * g < d // per <= g * v, (d, plan)
        # about 2 vectors a lane where a group can give it
        assert v == 2 or all(abs(w - 2) >= abs(v - 2)
                             for _, w in AC.vector_plans(d, dtype)), d
    # an out off a 16-byte boundary, or a q off one vector's levels
    assert AC.dequantize_plan(160, dtype, 0, 8) is None
    assert AC.dequantize_plan(160, dtype, 1, 16) is None
    assert AC.dequantize_plan(160, dtype, per, 16) is not None
    assert AC.dequantize_plan(32 * AC.MAX_VECS * per, dtype, 0, 0) == (
        32, AC.MAX_VECS)
    assert AC.dequantize_plan(32 * AC.MAX_VECS * per + per, dtype, 0,
                              0) is None


@pytest.mark.parametrize("d,dtype,plan", [
    (160, torch.float32, (32, 2)), (160, torch.bfloat16, (16, 2)),
    (64, torch.float32, (8, 2)), (64, torch.bfloat16, (4, 2)),
    (128, torch.float32, (16, 2)), (128, torch.bfloat16, (8, 2)),
    (256, torch.float32, (32, 2)), (256, torch.bfloat16, (16, 2)),
    (512, torch.float32, (32, 4)), (512, torch.bfloat16, (32, 2)),
    (576, torch.float32, (32, 5)), (576, torch.bfloat16, (32, 3)),
    (728, torch.float32, (32, 6)), (728, torch.bfloat16, (32, 3)),
    (768, torch.float32, (32, 6)), (768, torch.bfloat16, (32, 3)),
    (1024, torch.float32, (32, 8)), (1024, torch.bfloat16, (32, 4))])
def test_dequantize_plan_at_the_main_paths_widths(d, dtype, plan):
    """Every width the main path hands the link takes the vector path, on
    the plan the card's sweep of every plan chose (PERF.md §6, PR 21)."""
    assert AC.dequantize_plan(d, dtype, 0, 0) == plan


def test_dequantize_args_pass_the_plan_or_the_general_path():
    q = torch.zeros((5, 160), dtype=torch.int8)
    s = torch.ones((5, 1))
    out = torch.empty((5, 160), dtype=torch.bfloat16)
    args = AC.dequantize_args(q, s, out)
    assert args[3:] == (5, 160, 1, *AC.dequantize_plan(
        160, out.dtype, q.data_ptr(), out.data_ptr()))
    view = torch.zeros(5 * 160 + 1, dtype=torch.int8)[1:].view(5, 160)
    assert AC.dequantize_args(view, s, out)[3:] == (5, 160, 1, 1, 0)
    ragged = torch.zeros((5, 161), dtype=torch.int8)
    out = torch.empty((5, 161))
    assert AC.dequantize_args(ragged, s, out)[3:] == (5, 161, 0, 1, 0)
