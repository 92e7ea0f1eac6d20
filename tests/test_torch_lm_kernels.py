"""The port's LM kernels' plain versions (K7 flash attention, K8 SSD chunk)
against ``repro``'s Pallas kernels in interpret mode, on the CPU.

The same numpy-seeded inputs go through the reference's kernels and the
port's wrappers, whose CPU path is the plain PyTorch version of each
kernel (``chip_smoke.py`` holds the CUDA kernels against those plain
versions on the card).  Tolerances are the reference's own kernel tests'
(``tests/test_kernels.py``): K7 2e-6 in f32 and 2e-2 in bf16 (the output
is rounded to bf16 once, after an f32 softmax summed in another order);
K8 and the whole SSD 3e-4 (f32 sums over up to 64 state dims and 32 rows
in another order, then exponentials of cumulative sums).  The bf16 CUDA
kernel rounds P to bf16 before P V, which the plain version does not; a
test of the design, not of the kernel, holds a test-local torch emulation
of that arithmetic to the reference's bf16 bar against the Pallas kernel
(the kernel itself is held against the plain version on the card).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.ssd_scan import ops as JS
from repro.kernels.ssd_scan.ssd_scan import ssd_chunk_kernel
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import ops as TFO
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_bhsd
from repro_torch.kernels.ssd_scan import ops as TS
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_chunk

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-6),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("b,h,kv,s,d", [(1, 2, 1, 128, 64),
                                        (2, 4, 2, 256, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", DTYPES)
def test_flash_attention_matches_repro(b, h, kv, s, d, causal, dt):
    jd, td, tol = DTYPES[dt]
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in [(b, h, s, d), (b, kv, s, d), (b, kv, s, d)])
    want = flash_attention_pallas(*(jnp.asarray(a).astype(jd)
                                    for a in (q, k, v)), causal=causal)
    got = flash_attention_bhsd(*(torch.from_numpy(a).to(td)
                                 for a in (q, k, v)), causal=causal)
    assert got.dtype == td and got.shape == (b, h, s, d)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_flash_attention_model_layout():
    """ops.flash_attention takes (B, S, H, D) and gives what the (B, H, S,
    D) function gives, transposed."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 128, 4, 32)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 128, 2, 32)).astype(
        np.float32)) for _ in range(2))
    out = TFO.flash_attention(q, k, v)
    ref = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2)).transpose(1, 2)
    assert out.shape == q.shape
    assert torch.equal(out, ref)


@pytest.mark.parametrize("shapes", [
    ((1, 2, 128, 64), (1, 1, 256, 64)),      # S_q != S_k
    ((1, 3, 128, 64), (1, 2, 128, 64)),      # H % KV != 0
    ((1, 2, 200, 64), (1, 1, 200, 64)),      # S not a multiple of 128
])
def test_flash_attention_raises_where_repro_asserts(shapes):
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError):
        flash_attention_bhsd(q, k, k)


def _flash_bf16_tensor_core(q, k, v, causal, tile=64):
    """The arithmetic of K7's bf16 tensor-core kernel, emulated in torch:
    f32 scores of the bf16 q and k in log2 units (times f32(scale) *
    f32(log2 e)), the online softmax over tiles of 64 keys in f32, P
    rounded to bf16 before P V (f32 sums), l summed from the f32 P, the
    output rounded to bf16 once."""
    b, h, s, d = q.shape
    rep = h // k.shape[1]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(rep, dim=1) for t in (k, v))
    sl2 = (torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
           * torch.tensor(math.log2(math.e), dtype=torch.float32))
    neg = torch.tensor(-1e30)
    m, l = torch.full((b, h, s), -1e30), torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, tile):
        keys = torch.arange(k0, min(k0 + tile, s))[None, :]
        x = (qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)) * sl2
        if causal:
            x = torch.where(keys <= rows, x, neg)
        m_new = torch.maximum(m, x.amax(-1))
        p = torch.exp2(x - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        acc = (acc * corr[..., None]
               + p.bfloat16().float() @ vf[:, :, k0:k0 + tile])
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).bfloat16()


@pytest.mark.parametrize("b,h,kv,s,d", [(1, 2, 1, 128, 64),
                                        (2, 4, 2, 256, 64),
                                        (1, 6, 2, 80, 32),
                                        (1, 4, 1, 96, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_p_rounding_design_stays_within_repro_bar(
        b, h, kv, s, d, causal):
    """The numerics design of the bf16 tensor-core kernel, not the kernel:
    rounding P to bf16 before P V, as emulated in torch here, keeps the
    output within the reference's bf16 bar, 2e-2, of the Pallas kernel, at
    its test shapes, a ragged GQA case and head_dim 128 (S 80 and 96 end
    in a partial 64-key tile)."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in [(b, h, s, d), (b, kv, s, d), (b, kv, s, d)])
    want = flash_attention_pallas(*(jnp.asarray(a).astype(jnp.bfloat16)
                                    for a in (q, k, v)), causal=causal)
    got = _flash_bf16_tensor_core(*(torch.from_numpy(a).bfloat16()
                                    for a in (q, k, v)), causal)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_check_layout_asks_16_byte_rows():
    """The kernels read rows 16 bytes at a time: f32 strides must be
    multiples of 4 elements, bf16 strides (cp.async) multiples of 8."""
    f32 = torch.zeros((1, 2, 8, 36))[..., :32]       # row stride 36
    FA.check_layout(f32, "q")
    with pytest.raises(ValueError):
        FA.check_layout(torch.zeros((1, 2, 8, 36), dtype=torch.bfloat16)
                        [..., :32], "q")
    FA.check_layout(torch.zeros((1, 2, 8, 40), dtype=torch.bfloat16)
                    [..., :32], "q")
    with pytest.raises(ValueError):
        FA.check_layout(f32.transpose(-1, -2), "q")  # last axis strided


def _ssd_chunk_inputs(b, nc, q, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    xbar = rng.standard_normal((b, nc, q, h, p)).astype(np.float32)
    la = (-rng.uniform(0.0, 0.5, (b, nc, q, h))).astype(np.float32)
    B = (rng.standard_normal((b, nc, q, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, nc, q, g, n)) * 0.5).astype(np.float32)
    return xbar, la, B, C


@pytest.mark.parametrize("dims", [(1, 4, 16, 2, 16, 1, 16),
                                  (2, 3, 32, 4, 16, 2, 64),
                                  (1, 2, 8, 4, 32, 1, 16),
                                  (1, 2, 24, 4, 32, 2, 32)])   # q % 16 != 0
@pytest.mark.parametrize("bc", ["f32", "bf16"])
def test_ssd_chunk_matches_repro(dims, bc):
    """All four outputs (y_intra, states, dte, dfs), B and C in f32 or
    bf16 as the model passes them."""
    jd, td, _ = DTYPES[bc]
    xbar, la, B, C = _ssd_chunk_inputs(*dims)
    want = ssd_chunk_kernel(jnp.asarray(xbar), jnp.asarray(la),
                            jnp.asarray(B).astype(jd),
                            jnp.asarray(C).astype(jd))
    got = ssd_chunk(torch.from_numpy(xbar), torch.from_numpy(la),
                    torch.from_numpy(B).to(td), torch.from_numpy(C).to(td))
    for g_, w in zip(got, want):
        assert g_.dtype == torch.float32 and g_.shape == w.shape
        np.testing.assert_allclose(g_.numpy(), np.asarray(w),
                                   atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("b,l,h,p,g,n,q,bc", [
    pytest.param(1, 64, 2, 16, 1, 16, 16, "f32", id="1-64-2-16-1-16-16"),
    pytest.param(1, 96, 3, 16, 1, 64, 32, "f32", id="1-96-3-16-1-64-32"),
    (2, 64, 4, 16, 2, 16, 16, "f32"),      # g 2, rep 2: C over its group
    (2, 64, 4, 16, 2, 16, 16, "bf16"),
    (1, 96, 3, 16, 1, 64, 32, "bf16"),
    (1, 72, 6, 8, 3, 12, 24, "f32")])      # g 3, rep 2, q % 16 != 0
def test_ssd_ops_matches_repro(b, l, h, p, g, n, q, bc):
    """The whole chunked SSD, B and C in f32 or bf16 (as the model passes
    them; x and dt f32), against the reference within its 3e-4."""
    jd, td, _ = DTYPES[bc]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    B = (rng.standard_normal((b, l, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, l, g, n)) * 0.5).astype(np.float32)
    yj, fj = JS.ssd(*map(jnp.asarray, (x, dt, A)),
                    jnp.asarray(B).astype(jd), jnp.asarray(C).astype(jd), q)
    yt, ft = TS.ssd(*map(torch.from_numpy, (x, dt, A)),
                    torch.from_numpy(B).to(td), torch.from_numpy(C).to(td), q)
    assert yt.shape == (b, l, h, p) and ft.shape == (b, h, p, n)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=3e-4,
                               rtol=3e-4)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=3e-4,
                               rtol=3e-4)


def test_ssd_wrappers_raise_on_bad_shapes():
    xbar, la, B, C = map(torch.from_numpy, _ssd_chunk_inputs(1, 2, 8, 4, 16,
                                                             1, 16))
    with pytest.raises(ValueError):
        ssd_chunk(xbar, la[..., :3], B, C)           # la's heads
    with pytest.raises(ValueError):
        ssd_chunk(xbar[:, :, :, :3], la[..., :3], B.expand(1, 2, 8, 2, 16),
                  C.expand(1, 2, 8, 2, 16))          # 3 heads, 2 groups
    x = torch.zeros((1, 20, 2, 8))
    with pytest.raises(ValueError):
        TS.ssd(x, torch.ones((1, 20, 2)), torch.ones(2),
               torch.zeros((1, 20, 1, 8)), torch.zeros((1, 20, 1, 8)), 8)


@pytest.mark.parametrize("width,offset,n,seq_inner,want", [
    (1792, 1536, 128, False, 1),     # B of a row-major conv output
    (288, 272, 16, False, 1),        # C of the SMOKE config's
    (289, 256, 16, False, 0),        # odd row stride
    (288, 252, 16, False, 0),        # start 8 bytes off
    (132, 0, 20, False, 0),          # 40-byte rows
    (1792, 1536, 128, True, 2),      # the model's layout: sequence innermost
    (288, 272, 16, True, 2)])
def test_ssd_kernel_dims_pick_the_copy_path(width, offset, n, seq_inner,
                                            want):
    """K8 stages B and C by 16-byte pieces only where each lies whole and
    aligned along a contiguous axis (the state axis: 1, the sequence: 2);
    its C entry point gets the sizes, all 19 strides and the two modes."""
    from repro_torch.kernels.ssd_scan import ssd_scan as SSm

    conv = (torch.zeros((width, 2, 32), dtype=torch.bfloat16).permute(1, 2, 0)
            if seq_inner else torch.zeros((2, 32, width), dtype=torch.bfloat16))
    Bv = conv[..., offset:offset + n].unflatten(1, (2, 16)).unsqueeze(3)
    xbar = torch.zeros((2, 2, 16, 4, 8))
    la = torch.zeros((2, 2, 16, 4))
    assert SSm.copy_mode(Bv) == want and SSm.copy_mode(xbar) == 1
    dims = SSm.kernel_dims(xbar, la, Bv, Bv)
    assert dims[:7] == [2, 2, 16, 4, 8, 1, n] and len(dims) == 28
    assert dims[16:21] == list(Bv.stride()) and dims[26:] == [want, 1]
    assert SSm.copy_mode(xbar[..., :6]) == 0        # 24-byte rows of xbar


@pytest.mark.parametrize("dt", DTYPES)
def test_model_hands_k8_inputs_a_16_byte_copy_path(dt, monkeypatch):
    """The Mamba2 forward's xbar, B and C (the sequence innermost, as its
    conv lays them out) take one of K8's 16-byte staging paths, not the
    scalar one."""
    import dataclasses

    from repro_torch.configs import mamba2_130m
    from repro_torch.kernels.ssd_scan import ssd_scan as SSm
    from repro_torch.models.transformer import TransformerLM

    modes = []

    def ssd(xbar, la, B, C):
        modes.append(SSm.kernel_dims(xbar, la, B, C)[26:])
        return ssd_chunk(xbar, la, B, C)

    monkeypatch.setattr(TS, "ssd_chunk", ssd)
    cfg = mamba2_130m.SMOKE
    model = TransformerLM.build(dataclasses.replace(
        cfg, compute_dtype=DTYPES[dt][1]))
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    model.apply(params, toks, use_pallas=True)
    assert len(modes) == cfg.n_layers
    assert all(bc and x for bc, x in modes), modes


@pytest.mark.parametrize("name", ["smollm", "mamba2"])
@pytest.mark.parametrize("dt", DTYPES)
def test_model_hands_the_kernels_what_they_take(name, dt, monkeypatch):
    """The scoring forward passes K7 and K8 inputs the CUDA kernels accept
    (the layout and type checks they make on the card, run here on the CPU
    tensors), and launches each once per layer."""
    import dataclasses

    from repro_torch.configs import mamba2_130m, smollm_135m
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.ssd_scan import ssd_scan as SSm
    from repro_torch.models.transformer import TransformerLM

    calls = []

    def fa(q, k, v, causal=True):
        for t, n in ((q, "q"), (k, "k"), (v, "v")):
            FA.check_layout(t, n)
        assert q.dtype == k.dtype == v.dtype and q.shape[-1] in FA.HEAD_DIMS
        calls.append("K7")
        return flash_attention_bhsd(q, k, v, causal)

    def ssd(xbar, la, B, C):
        SSm.check_kernel_args(xbar, la, B, C)
        calls.append("K8")
        return ssd_chunk(xbar, la, B, C)

    monkeypatch.setattr(TFO, "flash_attention_bhsd", fa)
    monkeypatch.setattr(TS, "ssd_chunk", ssd)
    cfg = {"smollm": smollm_135m.SMOKE, "mamba2": mamba2_130m.SMOKE}[name]
    model = TransformerLM.build(dataclasses.replace(
        cfg, compute_dtype=DTYPES[dt][1]))
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    model.apply(params, toks, use_pallas=True)
    assert calls == ["K7" if name == "smollm" else "K8"] * cfg.n_layers
