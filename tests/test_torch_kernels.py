"""The port's cut-layer codec (K1 quantize, K2 dequantize, K3 fused
roundtrip, K4 fused roundtrip + cut noise) and DP clip (K5, K6) against
``repro``'s Pallas kernels, on the CPU.

The same numpy-seeded inputs go through ``repro.kernels.*.ops`` (Pallas in
interpret mode, compiled by XLA) and the port's ops, whose CPU path is the
plain PyTorch version of each kernel (the CUDA kernels are held against
those plain versions on the card by ``chip_smoke.py``).  Tolerance: none.
q, scale and every roundtrip are bit-equal for f32 and for bf16 input (the
reference's own test allows bf16 one level of q; both sides here compute
in f32 from the same bf16 values, so no level flips).  K4 is bit-equal too.
K5/K6 (``clip_accumulate``) sum in another order than the reference:
sums and norms within 1e-6 relative to the largest value of each leaf.
Under ``torch.func.vmap`` every straight-through op gives the same bits as
the per-example loop and a gradient of exactly the identity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.act_compress import ops as JA
from repro.kernels.cut_fuse import ops as JF
from repro.kernels.dp_clip.ops import clip_accumulate as j_clip_accumulate
from repro.wire import codec as JC
from repro_torch.device import resolve_device
from repro_torch.kernels.act_compress import act_compress as AC
from repro_torch.kernels.act_compress import ops as TA
from repro_torch.kernels.cut_fuse import cut_fuse as CF
from repro_torch.kernels.cut_fuse import ops as TF
from repro_torch.kernels.dp_clip import dp_clip as DC
from repro_torch.kernels.dp_clip.ops import clip_accumulate
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


# ---------------------------------------------------------------------------
# K4: fused roundtrip + row-weighted cut noise
# ---------------------------------------------------------------------------

def _noise_inputs(shape, dt, masked, seed=6):
    xj, xt = _inputs(shape, dt, seed)
    rng = np.random.default_rng(seed + 100)
    z = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    w = None
    if masked:
        w = (rng.random(shape[0]) < 0.6).astype(np.float32)
        w[0] = 1.0
    return xj, xt, z, w


@pytest.mark.parametrize("shape", [(3, 7, 5, 96), (4, 75, 96), (2, 9, 160),
                                   (5, 61, 160)])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_noise_roundtrip_bit_equal_to_repro(shape, dt, masked):
    """Row counts 105, 300, 18 and 305: none a multiple of the reference's
    256-row block.  Unmasked through the leaf wrapper the step calls;
    masked (the reference's pad-and-mask weights, which the stepwise
    engine does not use) through the row-level kernel wrapper."""
    xj, xt, z, w = _noise_inputs(shape, dt, masked)
    out_j = JF.cut_noise_roundtrip(xj, jnp.asarray(z),
                                   None if w is None else jnp.asarray(w))
    zt = torch.from_numpy(z)
    if w is None:
        out_t = TF.cut_noise_roundtrip(xt, zt)
        zw = zt
    else:
        d, wt = shape[-1], torch.from_numpy(w)
        w_rows = wt.repeat_interleave(xt[0].numel() // d).reshape(-1, 1)
        out_t = CF.noise_roundtrip_rows(xt.reshape(-1, d), zt.reshape(-1, d),
                                        w_rows).reshape(shape)
        zw = zt * wt.reshape((-1,) + (1,) * (len(shape) - 1))
    assert out_t.dtype == xt.dtype and out_t.shape == xt.shape
    np.testing.assert_array_equal(np.asarray(out_j.astype(jnp.float32)),
                                  _np(out_t))
    # K4 == K3 followed by the separate weighted add, bit for bit
    np.testing.assert_array_equal(
        _np(TF.fused_roundtrip(xt) + zw.to(xt.dtype)), _np(out_t))


def _vmapped(fn, x, *extra):
    """fn over the leading axis by torch.func.vmap, each example a batch of
    one, and the gradient of sum(fn(x) * x) per example."""
    one = lambda xi, *e: fn(xi.unsqueeze(0), *(t.unsqueeze(0) for t in e))[0]  # noqa: E731
    out = torch.func.vmap(one)(x, *extra)
    g = torch.func.vmap(torch.func.grad(
        lambda xi, *e: (one(xi, *e) * xi).sum()))(x, *extra)
    return out, g


@pytest.mark.parametrize("op", ["fused", "unfused", "noise", "bf16", "topk"])
def test_straight_through_under_vmap_grad(op):
    """Under vmap(grad) the forward gives the per-example loop's bits and
    the gradient of sum(f(x) * x) is exactly f(x) + x: the identity passes
    straight through (the per-example DP-SGD transform relies on it)."""
    _, xt = _inputs((4, 6, 5, 40), "f32", seed=7)
    z = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (4, 6, 5, 40)).astype(np.float32))
    fn, extra = {
        "fused": (TF.roundtrip_boundary, ()),
        "unfused": (TA.compress_boundary, ()),
        "noise": (TF.cut_noise_roundtrip, (z,)),
        "bf16": (TC.make_codec("bf16").roundtrip, ()),
        "topk": (TC.make_codec("topk:0.1").roundtrip, ()),
    }[op]
    out, g = _vmapped(fn, xt, *extra)
    loop = torch.cat([fn(xt[i:i + 1], *(e[i:i + 1] for e in extra))
                      for i in range(len(xt))])
    np.testing.assert_array_equal(out.numpy(), loop.numpy())
    np.testing.assert_array_equal(g.numpy(), (out + xt).numpy())


# ---------------------------------------------------------------------------
# K5/K6: the DP-SGD clip
# ---------------------------------------------------------------------------

def _grad_tree(shapes, scale=3.0, seed=9):
    rng = np.random.default_rng(seed)
    return {f"l{i}": (rng.standard_normal(s) * scale).astype(np.float32)
            for i, s in enumerate(shapes)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("shapes", [
    [(6, 8, 16)], [(3, 130), (3, 7)], [(16, 4, 4, 3), (16, 640), (16, 1)],
    [(4, 3, 3, 8, 12), (4, 12), (4, 12), (4, 700)],
])
@pytest.mark.parametrize("clip", [0.05, 1.0, float("inf")])
def test_clip_accumulate_matches_repro(shapes, clip):
    tree = _grad_tree(shapes)
    out_j, norms_j = j_clip_accumulate(
        {k: jnp.asarray(v) for k, v in tree.items()}, clip)
    out_t, norms_t = clip_accumulate(
        {k: torch.from_numpy(v) for k, v in tree.items()}, clip)
    assert list(out_t) == list(tree)
    for k in tree:
        assert tuple(out_t[k].shape) == tree[k].shape[1:]
        assert _rel(out_t[k].numpy(), out_j[k]) <= 1e-6, k
    assert _rel(norms_t.numpy(), norms_j) <= 1e-6


def test_clip_accumulate_zero_grads_match_repro():
    tree = {"a": np.zeros((4, 130), np.float32),
            "b": np.zeros((4, 3, 5), np.float32)}
    out_j, norms_j = j_clip_accumulate(
        {k: jnp.asarray(v) for k, v in tree.items()}, 1.0)
    out_t, norms_t = clip_accumulate(
        {k: torch.from_numpy(v) for k, v in tree.items()}, 1.0)
    assert norms_t.abs().max() == 0.0 == np.abs(np.asarray(norms_j)).max()
    for k in tree:
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]))


def test_clip_bounds_every_example():
    """After the clip every per-example contribution has norm <= C."""
    g = torch.from_numpy(_grad_tree([(8, 257)], scale=10.0)["l0"])
    out, norms = clip_accumulate({"g": g}, 0.5)
    scales = torch.clamp_max(0.5 / norms, 1.0)
    np.testing.assert_allclose(out["g"].numpy(),
                               (g * scales[:, None]).sum(0).numpy(),
                               atol=1e-5)
    assert ((g * scales[:, None]).norm(dim=1) <= 0.5 + 1e-5).all()


def test_clip_wrappers_on_cpu_count_no_launch_and_reject_meta():
    before = (DC.SQNORMS.launches, DC.SCALE_ACCUM.launches,
              CF.NOISE_ROUNDTRIP.launches)
    g = torch.ones((2, 5))
    table = DC.leaf_table([g])
    DC.sqnorms_leaves(table)
    DC.scale_accum_leaves(table, torch.ones((2, 1)))
    CF.noise_roundtrip_rows(g, g, torch.ones((2, 1)))
    assert (DC.SQNORMS.launches, DC.SCALE_ACCUM.launches,
            CF.NOISE_ROUNDTRIP.launches) == before
    meta = torch.empty((2, 5), device="meta")
    with pytest.raises(ValueError):
        DC.leaf_table([meta])
    with pytest.raises(ValueError):
        CF.noise_roundtrip_rows(meta, meta, meta)


@pytest.mark.parametrize("lens", [[130, 7, 1, 5000, 4097, 33], [5],
                                  [4, 8, 3, 4097]])
def test_leaf_table_values_cover_every_column_once(lens):
    """The int64 table K5 and K6 read, for odd lengths: its five segments
    at the offsets the kernels read them, and K6's groups of 4 columns
    (each found by binary search in the group prefix sums, as the kernel
    finds it) cover every column of every leaf once, each at its place in
    the concatenated output."""
    import bisect

    n = len(lens)
    ptrs = [4096 * (i + 1) for i in range(n)]
    vals = DC.table_values(ptrs, lens)
    assert len(vals) == 5 * n + 3
    assert vals[:n] == ptrs and vals[n:2 * n] == lens
    cprefix, prefix = vals[2 * n:3 * n + 1], vals[3 * n + 1:4 * n + 2]
    gprefix = vals[4 * n + 2:]
    assert cprefix == np.cumsum([0] + [-(-x // DC.CHUNK) for x in lens]
                                ).tolist()
    assert prefix == np.cumsum([0] + lens).tolist()
    assert gprefix[-1] == sum(-(-x // DC.GROUP) for x in lens)
    seen = []
    for i in range(gprefix[-1]):
        leaf = bisect.bisect_right(gprefix, i) - 1
        col = DC.GROUP * (i - gprefix[leaf])
        cnt = min(DC.GROUP, lens[leaf] - col)
        assert cnt >= 1
        seen += [prefix[leaf] + col + c for c in range(cnt)]
    assert seen == list(range(sum(lens)))
    table = DC.leaf_table([torch.zeros((2, x)) for x in lens])
    assert (table.chunks, table.groups) == (cprefix[-1], gprefix[-1])

