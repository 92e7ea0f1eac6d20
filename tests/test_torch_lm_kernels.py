"""The port's LM kernels' plain versions (K7 flash attention, K8 SSD chunk)
against ``repro``'s Pallas kernels in interpret mode, on the CPU.

The same numpy-seeded inputs go through the reference's kernels and the
port's wrappers, whose CPU path is the plain PyTorch version of each
kernel (``chip_smoke.py`` holds the CUDA kernels against those plain
versions on the card).  Tolerances are the reference's own kernel tests'
(``tests/test_kernels.py``): K7 2e-6 in f32 and 2e-2 in bf16 (the output
is rounded to bf16 once, after an f32 softmax summed in another order);
K8 and the whole SSD 3e-4 (f32 sums over up to 64 state dims and 32 rows
in another order, then exponentials of cumulative sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.ssd_scan import ops as JS
from repro.kernels.ssd_scan.ssd_scan import ssd_chunk_kernel
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


def _ssd_chunk_inputs(b, nc, q, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    xbar = rng.standard_normal((b, nc, q, h, p)).astype(np.float32)
    la = (-rng.uniform(0.0, 0.5, (b, nc, q, h))).astype(np.float32)
    B = (rng.standard_normal((b, nc, q, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, nc, q, g, n)) * 0.5).astype(np.float32)
    return xbar, la, B, C


@pytest.mark.parametrize("dims", [(1, 4, 16, 2, 16, 1, 16),
                                  (2, 3, 32, 4, 16, 2, 64),
                                  (1, 2, 8, 4, 32, 1, 16)])
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


@pytest.mark.parametrize("b,l,h,p,g,n,q", [(1, 64, 2, 16, 1, 16, 16),
                                           (1, 96, 3, 16, 1, 64, 32)])
def test_ssd_ops_matches_repro(b, l, h, p, g, n, q):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    B = (rng.standard_normal((b, l, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, l, g, n)) * 0.5).astype(np.float32)
    yj, fj = JS.ssd(*map(jnp.asarray, (x, dt, A, B, C)), q)
    yt, ft = TS.ssd(*map(torch.from_numpy, (x, dt, A, B, C)), q)
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
