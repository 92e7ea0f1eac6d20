"""K1 (per-row int8 quantize) at the widths and values that ``chip_smoke.py``
phase 3 holds the CUDA kernel to, on the CPU, and K1's launch plan.

Phase 3 holds K1 bit-equal to ``quantize_ref`` on the card, so
``quantize_ref`` must itself be the reference's at exactly those inputs: the
same numpy-seeded rows go through ``repro.kernels.act_compress.ops.quantize``
(Pallas in interpret mode) and ``repro_torch``'s ``ops.quantize`` (on the
CPU, ``quantize_ref``), in f32 and bf16, at the vector path's and the
general path's widths, with all-zero rows, and with rows whose every
x / scale but one is an exact .5 tie.  Tolerance: none, q and scale are
bit-equal.  ``quantize_plan`` is the wrapper's choice of K1's path, which
this file holds to its rules.
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


CASES = [("gauss", d) for d in (1, 3, 33, 161, 576, 728)]
CASES += [("zero_rows", d) for d in (3, 160, 161)]
CASES += [("ties", d) for d in (1, 160, 161, 728)]
MAKE = {"gauss": _gauss, "zero_rows": _zero_rows, "ties": _ties}


@pytest.mark.parametrize("kind,d", CASES, ids=[f"{k}-{d}" for k, d in CASES])
@pytest.mark.parametrize("dt", DTYPES)
def test_quantize_ref_equals_repro_at_phase3_cases(kind, d, dt):
    x = MAKE[kind](np.random.default_rng(d), d).astype(np.float32)
    jd, td = DTYPES[dt]
    qj, sj = JA.quantize(jnp.asarray(x).astype(jd))
    xt = torch.from_numpy(x).to(td)
    qt, st = TA.quantize(xt)
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    if kind == "zero_rows":
        zero = np.float32(R.MIN_AMAX) * np.float32(R.INV_127)
        assert (st.numpy()[::3] == zero).all() and not qt.numpy()[::3].any()
    if kind == "ties":
        r = xt.float().numpy() / st.numpy()
        tie = r - np.floor(r) == 0.5
        assert tie.sum() == ROWS * (d - 1)
        # half to even: no level is odd where the quotient was a tie
        assert not (qt.numpy()[tie] % 2).any()


@pytest.mark.parametrize("dtype,per", [(torch.float32, 4),
                                       (torch.bfloat16, 8)])
def test_quantize_plan_takes_the_vector_path_only_where_it_can(dtype, per):
    for d in range(1, 40 * per):
        plan = AC.quantize_plan(d, dtype, 0, 0)
        if d % per or d // per > 32 * AC.MAX_VECS:
            assert plan is None, d
            continue
        g, v = plan
        assert g in (1, 2, 4, 8, 16, 32) and 1 <= v <= AC.MAX_VECS
        # v is the fewest vectors a lane that cover the row
        assert (v - 1) * g < d // per <= g * v, (d, plan)
    # an x off a 16-byte boundary, or a q off one vector's levels
    assert AC.quantize_plan(160, dtype, 8, 0) is None
    assert AC.quantize_plan(160, dtype, 16, 1) is None
    assert AC.quantize_plan(160, dtype, 16, per) is not None
    assert AC.quantize_plan(32 * AC.MAX_VECS * per, dtype, 0, 0) == (
        32, AC.MAX_VECS)
    assert AC.quantize_plan(32 * AC.MAX_VECS * per + per, dtype, 0, 0) is None


@pytest.mark.parametrize("d,dtype,plan", [
    (160, torch.bfloat16, (4, 5)), (160, torch.float32, (8, 5)),
    (64, torch.bfloat16, (2, 4)), (64, torch.float32, (4, 4)),
    (728, torch.bfloat16, (32, 3)), (728, torch.float32, (32, 6)),
    (576, torch.bfloat16, (16, 5)), (1024, torch.float32, (32, 8))])
def test_quantize_plan_at_the_main_paths_widths(d, dtype, plan):
    """No idle vector slot where a group fits a row exactly (D = 160 and
    64), whole 32-byte sectors a group, about 4 vectors a lane."""
    assert AC.quantize_plan(d, dtype, 0, 0) == plan


def test_quantize_args_pass_the_plan_or_the_general_path():
    x = torch.zeros((5, 160), dtype=torch.bfloat16)
    q = torch.empty((5, 160), dtype=torch.int8)
    s = torch.empty((5, 1))
    args = AC.quantize_args(x, q, s)
    assert args[3:] == (5, 160, 1, *AC.quantize_plan(
        160, x.dtype, x.data_ptr(), q.data_ptr()))
    view = torch.zeros(5 * 160 + 1, dtype=torch.bfloat16)[1:].view(5, 160)
    assert AC.quantize_args(view, q, s)[3:] == (5, 160, 1, 1, 0)
