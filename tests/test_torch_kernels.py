"""The port's cut-layer codec (K1 quantize, K2 dequantize, K3 fused
roundtrip) against ``repro``'s Pallas kernels, on the CPU.

The same numpy-seeded inputs go through ``repro.kernels.*.ops`` (Pallas in
interpret mode, compiled by XLA) and the port's ops, whose CPU path is the
plain PyTorch version of each kernel (the CUDA kernels are held against
those plain versions on the card by ``chip_smoke.py``).  Tolerance: none.
q, scale and every roundtrip are bit-equal for f32 and for bf16 input (the
reference's own test allows bf16 one level of q; both sides here compute
in f32 from the same bf16 values, so no level flips).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.act_compress import ops as JA
from repro.kernels.cut_fuse import ops as JF
from repro.wire import codec as JC
from repro_torch.device import resolve_device
from repro_torch.kernels.act_compress import act_compress as AC
from repro_torch.kernels.act_compress import ops as TA
from repro_torch.kernels.cut_fuse import cut_fuse as CF
from repro_torch.kernels.cut_fuse import ops as TF
from repro_torch.wire import Transport
from repro_torch.wire import codec as TC

torch.set_num_threads(2)

SHAPES = [(64, 128), (8, 32, 64), (250, 512), (7, 96), (2, 7, 7, 160)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, dt, seed=0):
    x = (np.random.default_rng(seed).standard_normal(shape) * 3).astype(
        np.float32)
    jd, td = DTYPES[dt]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_quantize_matches_repro(shape, dt):
    xj, xt = _inputs(shape, dt)
    qj, sj = JA.quantize(xj)
    qt, st = TA.quantize(xt)
    assert qt.dtype == torch.int8 and tuple(qt.shape) == shape
    assert tuple(st.shape) == shape[:-1] + (1,)
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_dequantize_matches_repro(shape, dt):
    xj, _ = _inputs(shape, "f32", seed=1)
    qj, sj = JA.quantize(xj)
    jd, td = DTYPES[dt]
    out_j = JA.dequantize(qj, sj, dtype=jd)
    out_t = TA.dequantize(torch.from_numpy(np.array(qj)),
                          torch.from_numpy(np.array(sj)), td)
    assert out_t.dtype == td
    np.testing.assert_array_equal(np.asarray(out_j.astype(jnp.float32)),
                                  _np(out_t))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_roundtrip_bit_equal_to_repro(shape, dt):
    xj, xt = _inputs(shape, dt, seed=2)
    fused_j = np.asarray(JF.fused_roundtrip(xj).astype(jnp.float32))
    fused_t = TF.fused_roundtrip(xt)
    unfused_t = TA.compress_boundary(xt)
    assert fused_t.dtype == xt.dtype
    np.testing.assert_array_equal(fused_j, _np(fused_t))
    # K3 == K2 o K1, bit for bit, in the port as in the reference
    np.testing.assert_array_equal(_np(fused_t), _np(unfused_t))
    np.testing.assert_array_equal(
        np.asarray(JA.compress_boundary(xj).astype(jnp.float32)), fused_j)


@pytest.mark.parametrize("boundary", ["fused", "unfused"])
def test_straight_through_gradient_is_identity(boundary):
    xj, xt = _inputs((16, 64), "f32", seed=3)
    fj = JF.roundtrip_boundary if boundary == "fused" else \
        JA.compress_boundary
    ft = TF.roundtrip_boundary if boundary == "fused" else \
        TA.compress_boundary
    gj = jax.grad(lambda x: (fj(x) * x).sum())(xj)
    xt.requires_grad_(True)
    (gt,) = torch.autograd.grad((ft(xt) * xt).sum(), xt)
    # STE: d/dx [roundtrip(x) * x] = roundtrip(x) + x
    expect = ft(xt).detach() + xt.detach()
    np.testing.assert_array_equal(gt.numpy(), expect.numpy())
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (AC.QUANTIZE.launches, AC.DEQUANTIZE.launches,
              CF.ROUNDTRIP.launches)
    _, xt = _inputs((8, 24), "f32")
    q, s = AC.quantize_rows(xt)
    AC.dequantize_rows(q, s, torch.float32)
    CF.roundtrip_rows(xt)
    assert (AC.QUANTIZE.launches, AC.DEQUANTIZE.launches,
            CF.ROUNDTRIP.launches) == before


def test_wrappers_reject_devices_without_a_kernel():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError):
        AC.quantize_rows(x)
    with pytest.raises(ValueError):
        CF.roundtrip_rows(x)


def test_default_device_is_cuda_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Transport("int8")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", ["identity", "bf16", "int8", "topk:0.1"])
@pytest.mark.parametrize("shape", [(16, 56, 56, 160), (4, 8, 8, 48), (7,)])
def test_codec_wire_bytes_equal_repro(name, shape):
    spec_j = jax.ShapeDtypeStruct(shape, jnp.float32)
    spec_t = torch.empty(shape, device="meta")
    assert TC.make_codec(name).wire_bytes(spec_t) == \
        JC.make_codec(name).wire_bytes(spec_j)


@pytest.mark.parametrize("fuse", [True, False])
def test_transport_boundary_is_the_int8_roundtrip(fuse):
    xj, xt = _inputs((3, 5, 5, 40), "f32", seed=4)
    tr = Transport("int8", fuse=fuse, device="cpu")
    np.testing.assert_array_equal(tr.boundary(xt).numpy(),
                                  np.asarray(JF.fused_roundtrip(xj)))
    with pytest.raises(ValueError):
        tr.boundary(torch.empty((2, 4), device="meta"))


@pytest.mark.parametrize("name", ["identity", "bf16", "int8", "topk:0.1"])
def test_codec_roundtrip_and_payload_equal_repro(name):
    """Each codec's in-graph roundtrip and its encode-then-decode are
    bit-equal to the reference's, and the gradient passes straight
    through."""
    xj, xt = _inputs((3, 5, 5, 40), "f32", seed=5)
    cj, ct = JC.make_codec(name), TC.make_codec(name)
    rt = ct.roundtrip(xt)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(cj.roundtrip(xj)))
    np.testing.assert_array_equal(ct.decode(ct.encode(xt), xt).numpy(),
                                  rt.numpy())
    xt.requires_grad_(True)
    (g,) = torch.autograd.grad(ct.roundtrip(xt).sum(), xt)
    np.testing.assert_array_equal(g.numpy(), np.ones(xt.shape, np.float32))
