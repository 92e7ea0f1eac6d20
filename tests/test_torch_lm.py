"""The port's LM slice against ``repro`` on the CPU: token streams, param
interop, and the cacheless scoring forward (``TransformerLM.apply`` /
``loss`` with ``use_pallas=True``, which reaches K7 and K8; on the CPU
their plain versions) on SmolLM's and Mamba2's SMOKE configs and a GQA
config (4 heads over 2 kv heads).  The reference runs its Pallas kernels in
interpret mode.

Params are drawn by the port and converted (``lm_params_to_numpy``); the
tokens are numpy-seeded.  Tolerances:
  * f32 compute: logits within 1e-5 of their largest magnitude (float32
    round-off of other summation orders through two or three layers; the
    SSD's exponentials of cumulative sums alone differ by about 1e-6
    relative), losses within 1e-5;
  * bf16 compute: logits within 0.15 absolute (about five bf16 ulps at the
    logits' magnitude of 4 to 8, where one ulp is 2^-5): XLA rounds to bf16
    once per fused region and PyTorch after every op, so every layer's
    activations differ by a few bf16 ulps (2^-8 relative); losses within
    1e-2;
  * the int8 cut link: the codec is bit-equal, but a cut-tensor element
    within round-off of a half level lands on the neighbouring level, so
    the roundtripped cut tensors may differ by one level (the row's
    scale) and are held to that; the server segment is then fed the same
    cut tensor in both and held to 1e-5 of its logits' scale, and the
    losses over the link to 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_130m as JM
from repro.configs import smollm_135m as JSM
from repro.data import synthetic as JD
from repro.kernels.cut_fuse import ops as JF
from repro.models.transformer import ModelConfig as JConfig
from repro.models.transformer import TransformerLM as JLM
from repro_torch.configs import mamba2_130m as TM
from repro_torch.configs import smollm_135m as TSM
from repro_torch.data import synthetic as TD
from repro_torch.interop import lm_params_from_jax, lm_params_to_numpy
from repro_torch.kernels.cut_fuse import ops as TF
from repro_torch.models.transformer import ModelConfig as TConfig
from repro_torch.models.transformer import TransformerLM
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

# the GQA model of tests/test_serving.py
GQA = dict(name="t", arch_type="dense", n_layers=3, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=97, cut_layer=1, remat=False)
CONFIGS = {"smollm": (JSM.SMOKE, TSM.SMOKE), "mamba2": (JM.SMOKE, TM.SMOKE),
           "gqa": (JConfig(**GQA), TConfig(**GQA))}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SEQ = 64           # < 128 (K7's block) and a multiple of Mamba2 SMOKE's chunk


def _pair(name, dt="f32", seed=0):
    jc, tc = CONFIGS[name]
    jd, td = DTYPES[dt]
    jm = JLM.build(dataclasses.replace(jc, compute_dtype=jd))
    tm = TransformerLM.build(dataclasses.replace(tc, compute_dtype=td))
    pt = tm.init_params(torch.Generator().manual_seed(seed), "cpu")
    pj = jax.tree.map(jnp.asarray, lm_params_to_numpy(pt))
    return jm, tm, pj, pt


def _tokens(vocab, n=2, s=SEQ + 1, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (n, s)).astype(
        np.int32)


def test_token_streams_byte_identical():
    a = JD.token_stream(3, 512, 4, 40)
    b = TD.token_stream(3, 512, 4, 40)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for x, y in zip(JD.lm_clients(0, 49152, 3, 2, 33),
                    TD.lm_clients(0, 49152, 3, 2, 33)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("name", ["smollm", "mamba2"])
def test_lm_params_round_trip(name):
    """The reference's own init, through the port and back: same tree, same
    bits; runs keep their layer axis, and a run split at the cut is
    ``run_<id>`` in front and ``run_<id + 1000>`` in the middle."""
    jc, tc = CONFIGS[name]
    jm = JLM.build(dataclasses.replace(jc, n_layers=3, cut_layer=1))
    tm = TransformerLM.build(dataclasses.replace(tc, n_layers=3, cut_layer=1))
    pj = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))
    pt = lm_params_from_jax(pj)
    assert set(pt["front"]) == {"embed", "run_0"}
    assert set(pt["middle"]) == {"run_1000", "final_norm", "head"}
    assert tree_leaves(pt["front"]["run_0"])[0].shape[0] == 1
    assert tree_leaves(pt["middle"]["run_1000"])[0].shape[0] == 2
    back = lm_params_to_numpy(pt)
    assert jax.tree.structure(back) == jax.tree.structure(pj)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pj)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the port draws the same tree shape
    mine = lm_params_to_numpy(tm.init_params(torch.Generator().manual_seed(0),
                                             "cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(pj)
    assert [a.shape for a in jax.tree.leaves(mine)] == \
        [a.shape for a in jax.tree.leaves(pj)]


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("dt", DTYPES)
def test_scoring_forward_matches_repro(name, dt):
    jm, tm, pj, pt = _pair(name, dt)
    toks = _tokens(jm.cfg.vocab_size)
    lj, _, _ = jm.apply(pj, jnp.asarray(toks[:, :-1]), use_pallas=True)
    lt, cache, aux = tm.apply(pt, torch.from_numpy(toks[:, :-1]),
                              use_pallas=True)
    assert cache is None and float(aux) == 0.0
    assert lt.dtype == DTYPES[dt][1] and lt.shape == lj.shape
    lossj = float(jm.loss(pj, {"tokens": jnp.asarray(toks)}, train=False,
                          use_pallas=True))
    losst = float(tm.loss(pt, {"tokens": torch.from_numpy(toks)},
                          train=False, use_pallas=True))
    lj = np.asarray(lj, np.float32)
    tol, ltol = ((1e-5 * np.abs(lj).max(), 1e-5), (1e-5, 1e-5)) \
        if dt == "f32" else ((0.15, 0.0), (1e-2, 0.0))
    np.testing.assert_allclose(lt.float().numpy(), lj, atol=tol[0],
                               rtol=tol[1])
    np.testing.assert_allclose(losst, lossj, atol=ltol[0], rtol=ltol[1])


@pytest.mark.parametrize("name", ["smollm", "mamba2"])
def test_pallas_and_plain_paths_agree(name):
    """use_pallas True and False are the same function (f32, 1e-5)."""
    _, tm, _, pt = _pair(name)
    toks = torch.from_numpy(_tokens(tm.cfg.vocab_size)[:, :-1])
    a, _, _ = tm.apply(pt, toks, use_pallas=True)
    b, _, _ = tm.apply(pt, toks, use_pallas=False)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_int8_cut_link_matches_repro(name):
    jm, tm, pj, pt = _pair(name)
    toks = _tokens(jm.cfg.vocab_size)[:, :-1]
    hj, _, _ = jm.apply(pj, jnp.asarray(toks), use_pallas=True,
                        segment_range=(0, 1))
    ht, _, _ = tm.apply(pt, torch.from_numpy(toks), use_pallas=True,
                        segment_range=(0, 1))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-5,
                               rtol=1e-5)
    cut_j = np.asarray(JF.fused_roundtrip(hj))
    cut_t = TF.roundtrip_boundary(ht)
    level = np.abs(np.asarray(hj)).max(axis=-1, keepdims=True) / 127
    assert (np.abs(cut_t.numpy() - cut_j) <= level * 1.01 + 1e-6).all()
    # the server segment on the same cut tensor
    mj, _, _ = jm.apply(pj, jnp.asarray(cut_j), use_pallas=True,
                        segment_range=(1, None))
    mt, _, _ = tm.apply(pt, torch.from_numpy(cut_j.copy()), use_pallas=True,
                        segment_range=(1, None))
    mj = np.asarray(mj)
    np.testing.assert_allclose(mt.numpy(), mj, atol=1e-5 * np.abs(mj).max(),
                               rtol=1e-5)
    # and boundary_fn sits between the two segments
    full, _, _ = tm.apply(pt, torch.from_numpy(toks), use_pallas=True,
                          boundary_fn=TF.roundtrip_boundary)
    split, _, _ = tm.apply(pt, cut_t, use_pallas=True,
                           segment_range=(1, None))
    assert torch.equal(full, split)
    # the loss over the link: a level flipped in a few cut elements moves
    # the mean loss by far less than 1e-3
    toks = _tokens(jm.cfg.vocab_size)
    lossj = float(jm.loss(pj, {"tokens": jnp.asarray(toks)}, train=False,
                          use_pallas=True, boundary_fn=JF.roundtrip_boundary))
    losst = float(tm.loss(pt, {"tokens": torch.from_numpy(toks)},
                          train=False, use_pallas=True,
                          boundary_fn=TF.roundtrip_boundary))
    assert abs(losst - lossj) <= 1e-3


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = TransformerLM.build(TConfig(**GQA))
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.cache_init(1, 8)
