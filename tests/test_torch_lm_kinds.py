"""Every model kind of the port's ``TransformerLM`` against
``repro.models.transformer`` on the CPU, f32 compute: the ten registry
SMOKE configs (dense, MoE top-1 and top-2 with ``first_k_dense``, the
Zamba2 hybrid with its shared block, the vision and audio frontends,
Mamba2), LS and NLS, a padded vocabulary, remat, the shared block owned
by the front, decoding past a frontend's prefix, ``lm_adapter`` (LS, NLS
and under ``cast_adapter``), the registry and ``param_shapes`` of every
full CONFIG.

Params are drawn by the port and converted (``lm_params_to_numpy``);
tokens and frontend embeddings are numpy-seeded.  Tolerances:
  * logits within 1e-5 of their largest magnitude and losses within 1e-5
    (float32 round-off of other summation orders through two to six
    layers; the SSD's exponentials of cumulative sums alone differ by
    about 1e-6 relative); the MoE aux within 1e-6 relative;
  * ``cast_adapter`` bf16: losses within 2e-2 (a few bf16 ulps of every
    layer's activations, as in ``tests/test_torch_lm.py``);
  * remat on against off: gradients bit-equal (the same ops recomputed),
    fewer tensors saved for the backward pass with it on;
  * ``param_shapes``: every leaf's shape equal to ``jax.eval_shape`` of the
    reference's init, and nothing allocated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core.partition import cast_adapter as j_cast_adapter
from repro.core.partition import lm_adapter as j_lm_adapter
from repro.models.transformer import ModelConfig as JConfig
from repro.models.transformer import TransformerLM as JLM
from repro_torch.configs import registry as TR
from repro_torch.core.partition import cast_adapter, lm_adapter
from repro_torch.interop import lm_params_to_numpy
from repro_torch.launch.train import param_shapes
from repro_torch.models.layers import param_count
from repro_torch.models.transformer import ModelConfig as TConfig
from repro_torch.models.transformer import TransformerLM
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

ARCHS = list(JR.ARCH_IDS)
SEQ = 17                         # tokens per sequence, the last a label


def _configs(jc, **kw):
    """The reference config and the port's twin, f32 compute."""
    jc = dataclasses.replace(jc, compute_dtype=jnp.float32, **kw)
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    fields.update(compute_dtype=torch.float32, param_dtype=torch.float32)
    return jc, TConfig(**fields)


def _pair(jc, nls=False, seed=0, **kw):
    jc, tc = _configs(jc, **kw)
    jm, tm = JLM.build(jc, nls=nls), TransformerLM.build(tc, nls=nls)
    pt = tm.init_params(torch.Generator().manual_seed(seed), "cpu")
    pj = jax.tree.map(jnp.asarray, lm_params_to_numpy(pt))
    return jm, tm, pj, pt


def _batch(cfg, n=2, seq=SEQ, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (n, seq)).astype(
        np.int32)}
    if cfg.frontend is not None:
        b["frontend_emb"] = rng.normal(
            size=(n, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                np.float32)
    return b


def _both(b):
    return (jax.tree.map(jnp.asarray, b),
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close(have, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(have, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_registry_matches_reference():
    assert TR.ARCH_IDS == JR.ARCH_IDS
    assert TR.INPUT_SHAPES == JR.INPUT_SHAPES
    assert TR.combos() == JR.combos()
    for aid in ARCHS:
        je, te = JR.get(aid), TR.get(aid)
        assert (te.shapes, te.skip_notes) == (je.shapes, je.skip_notes)
        for j, t in ((je.config, te.config), (je.smoke, te.smoke)):
            for f in dataclasses.fields(j):
                if f.name not in ("param_dtype", "compute_dtype"):
                    assert getattr(t, f.name) == getattr(j, f.name), (
                        aid, f.name)
            assert str(t.compute_dtype)[6:] == jnp.dtype(
                j.compute_dtype).name
    with pytest.raises(KeyError):
        TR.get("nope")


@pytest.mark.parametrize("nls", [False, True], ids=["ls", "nls"])
@pytest.mark.parametrize("arch", ARCHS)
def test_build_matches_reference(arch, nls):
    """Every kind, frontend and the U-shaped tail build, segment for
    segment and run for run, for the SMOKE and the full CONFIG."""
    for jc in (JR.get(arch).smoke, JR.get(arch).config):
        jm, tm = JLM.build(jc, nls=nls), TransformerLM.build(
            TR.get(arch).smoke if jc is JR.get(arch).smoke
            else TR.get(arch).config, nls=nls)
        assert [dataclasses.asdict(s) for s in tm.segments] == [
            dataclasses.asdict(s) for s in jm.segments]


@pytest.mark.parametrize("nls", [False, True], ids=["ls", "nls"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_loss_match_reference(arch, nls):
    jm, tm, pj, pt = _pair(JR.get(arch).smoke, nls)
    jb, tb = _both(_batch(tm.cfg))
    fe_j, fe_t = jb.get("frontend_emb"), tb.get("frontend_emb")
    lj, _, aj = jax.jit(lambda p, t, f: jm.apply(p, t, frontend_emb=f))(
        pj, jb["tokens"][:, :-1], fe_j)
    lt, _, at = tm.apply(pt, tb["tokens"][:, :-1], frontend_emb=fe_t)
    assert lt.shape == lj.shape
    _close(lt.numpy(), lj)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    assert (float(at) > 0) == (tm.cfg.arch_type == "moe")
    fj = float(jax.jit(jm.loss)(pj, jb))
    ft = float(tm.loss(pt, tb))
    assert abs(ft - fj) <= 1e-5


def test_padded_vocab_masks_the_padding_slots():
    """``vocab_pad_to``: the embedding and head are padded_vocab wide and
    the loss keeps the padding slots out of the softmax."""
    jm, tm, pj, pt = _pair(JR.get("minicpm-2b").smoke, vocab_pad_to=128)
    assert tm.cfg.padded_vocab == 512 and tm.cfg.vocab_size == 503
    assert pt["front"]["embed"]["table"].shape[0] == 512
    assert pt["middle"]["head"]["w"].shape[1] == 512
    jb, tb = _both(_batch(tm.cfg))
    lj, _, _ = jm.apply(pj, jb["tokens"][:, :-1])
    lt, _, _ = tm.apply(pt, tb["tokens"][:, :-1])
    _close(lt.numpy(), lj)
    fj, ft = float(jm.loss(pj, jb)), float(tm.loss(pt, tb))
    assert abs(ft - fj) <= 1e-5
    # the unmasked cross-entropy over all 512 slots is larger
    full = torch.logsumexp(lt.float(), -1).mean()
    assert ft < float(full - torch.gather(
        lt, -1, tb["tokens"][:, 1:, None].long())[..., 0].mean())


@pytest.mark.parametrize("arch", ["smollm-135m", "llama4-scout-17b-a16e",
                                  "zamba2-7b", "mamba2-130m"])
def test_remat_gradients_equal_plain(arch):
    jc = JR.get(arch).smoke
    _, on, _, pt = _pair(jc, remat=True)
    off = TransformerLM.build(dataclasses.replace(on.cfg, remat=False))
    tb = _both(_batch(on.cfg))[1]
    grads, saved = [], []
    for model in (on, off):
        p = tree_map(lambda t: t.clone().requires_grad_(True), pt)
        n = [0]

        def pack(t, n=n):
            n[0] += 1
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = model.loss(p, tb, train=True)
        loss.backward()
        grads.append([l.grad for l in tree_leaves(p)])
        saved.append(n[0])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    # remat keeps the layers' inputs only, not their intermediates
    assert saved[0] < saved[1]


def test_remat_matches_reference_gradients():
    """remat on in both packages (``jax.checkpoint`` under the scan, one
    ``torch.utils.checkpoint`` per layer): gradients within 5e-5 of each
    leaf's largest magnitude."""
    jm, tm, pj, pt = _pair(JR.get("kimi-k2-1t-a32b").smoke, remat=True)
    jb, tb = _both(_batch(tm.cfg))
    gj = jax.jit(jax.grad(lambda p: jm.loss(p, jb, train=True)))(pj)
    p = tree_map(lambda t: t.clone().requires_grad_(True), pt)
    tm.loss(p, tb, train=True).backward()
    gt = lm_params_to_numpy(tree_map(lambda t: t.grad, p))
    for a, b in zip(jax.tree.leaves(gj), jax.tree.leaves(gt)):
        _close(b, a, 5e-5)


HYBRID = JConfig(name="hy", arch_type="hybrid", n_layers=3, d_model=64,
                 n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=97,
                 head_dim=16, ssm_state=8, ssm_head_dim=16, ssm_chunk=8,
                 hybrid_attn_every=1, cut_layer=2, remat=False)


def test_shared_block_owned_by_the_front():
    """cut 2 of mamba, shared, mamba, shared, ...: the front owns the one
    shared set and the middle's applications take it through ``apply``;
    the middle alone (no front params) finds no set, and both packages
    raise for it."""
    jm, tm, pj, pt = _pair(HYBRID)
    assert tm.segments[0].has_shared and not tm.segments[1].has_shared
    assert "shared_block" in pt["front"]
    assert not any(k.startswith("run_") and v is None
                   for k, v in pt["middle"].items())
    jb, tb = _both(_batch(tm.cfg))
    lj, _, _ = jm.apply(pj, jb["tokens"][:, :-1])
    lt, _, _ = tm.apply(pt, tb["tokens"][:, :-1])
    _close(lt.numpy(), lj)
    hj, _, _ = jm.apply(pj, jb["tokens"][:, :-1], segment_range=(0, 1))
    with pytest.raises(TypeError):
        jm.apply({"middle": pj["middle"]}, hj, segment_range=(1, 2))
    ht = torch.from_numpy(np.array(hj))
    with pytest.raises(TypeError):
        tm.apply({"middle": pt["middle"]}, ht, segment_range=(1, 2))
    # with the front's params beside it the middle runs alone
    mj, _, _ = jm.apply(pj, hj, segment_range=(1, 2))
    mt, _, _ = tm.apply(pt, ht, segment_range=(1, 2))
    _close(mt.numpy(), mj)


@pytest.mark.parametrize("arch", ["internvl2-76b", "zamba2-7b"])
def test_decode_past_the_prefix(arch):
    """A prefill over the frontend's embeddings and the prompt into the
    caches, then two decode steps that pass no frontend (the positions
    count the prefix): each step's logits as the reference's."""
    jm, tm, pj, pt = _pair(JR.get(arch).smoke)
    cfg = tm.cfg
    b = _batch(cfg, seq=9)
    jb, tb = _both(b)
    f = cfg.frontend_tokens if cfg.frontend else 0
    total = f + 9 + 2
    jc = jm.cache_init(2, total, jnp.float32)
    tc = tm.cache_init(2, total, torch.float32, device="cpu")
    lj, jc, _ = jm.apply(pj, jb["tokens"], cache=jc,
                         frontend_emb=jb.get("frontend_emb"))
    lt, tc, _ = tm.apply(pt, tb["tokens"], cache=tc,
                         frontend_emb=tb.get("frontend_emb"))
    _close(lt.numpy(), lj)
    tok = np.argmax(np.asarray(lj)[:, -1:], -1).astype(np.int32)
    for step in range(2):
        pos = np.full((2, 1), f + 9 + step, np.int32)
        lj, jc, _ = jm.apply(pj, jnp.asarray(tok), positions=jnp.asarray(pos),
                             cache=jc)
        lt, tc, _ = tm.apply(pt, torch.from_numpy(tok),
                             positions=torch.from_numpy(pos), cache=tc)
        _close(lt.numpy(), lj)
        tok = np.argmax(np.asarray(lj), -1).astype(np.int32)


@pytest.mark.parametrize("nls", [False, True], ids=["ls", "nls"])
@pytest.mark.parametrize("arch", ["smollm-135m", "musicgen-medium",
                                  "kimi-k2-1t-a32b"])
def test_lm_adapter_split_equals_full_and_reference(arch, nls):
    """The adapter's segments one after another equal the unsplit forward
    (as ``tests/test_system.py``'s split test), and its losses and scores
    equal the reference adapter's."""
    jm, tm, pj, pt = _pair(JR.get(arch).smoke, nls)
    ja, ta = j_lm_adapter(jm), lm_adapter(tm)
    assert ta.seg_names == ja.seg_names == (
        ("front", "middle", "tail") if nls else ("front", "middle"))
    jb, tb = _both(_batch(tm.cfg))
    x = ta.inputs(tb)
    for seg in ta.seg_names:
        x = ta.apply_seg(seg, pt[seg], x, tb, False)
    direct, _, _ = tm.apply(pt, tb["tokens"][:, :-1],
                            frontend_emb=tb.get("frontend_emb"))
    _close(x.numpy(), direct.numpy())
    jx = ja.inputs(jb)
    for seg in ja.seg_names:
        jx = ja.apply_seg(seg, pj[seg], jx, jb, False)
    _close(x.numpy(), jx)
    assert abs(float(ta.loss_from_output(x, tb))
               - float(ja.loss_from_output(jx, jb))) <= 1e-5
    _close(ta.per_example_loss(x, tb).numpy(), ja.per_example_loss(jx, jb))
    _close(ta.scores_from_output(x).numpy(), ja.scores_from_output(jx))
    assert abs(float(ta.full_loss(pt, tb))
               - float(ja.full_loss(pj, jb))) <= 1e-5


@pytest.mark.parametrize("nls", [False, True], ids=["ls", "nls"])
def test_lm_adapter_under_cast_adapter(nls):
    """bf16 compute through ``cast_adapter`` (params and activations cast
    per segment, f32 masters): the loss near the reference's and its
    gradient f32 on every master leaf."""
    jm, tm, pj, pt = _pair(JR.get("llama4-scout-17b-a16e").smoke, nls)
    ja = j_cast_adapter(j_lm_adapter(jm), "bf16")
    ta = cast_adapter(lm_adapter(tm), "bf16")
    jb, tb = _both(_batch(tm.cfg))
    fj = float(ja.full_loss(pj, jb, train=True))
    p = tree_map(lambda t: t.clone().requires_grad_(True), pt)
    loss = ta.full_loss(p, tb, train=True)
    assert abs(float(loss.detach()) - fj) <= 2e-2
    loss.backward()
    assert all(l.grad.dtype == torch.float32 for l in tree_leaves(p))


def test_lm_adapter_boundary_specs():
    """The adapter's cut shapes on the meta device (no params drawn)."""
    tm = TransformerLM.build(_configs(JR.get("musicgen-medium").smoke)[1],
                             nls=True)
    specs = lm_adapter(tm).boundary_specs(_batch(tm.cfg))
    f = tm.cfg.frontend_tokens
    assert specs["front->middle"].shape == (2, f + SEQ - 1, tm.cfg.d_model)
    assert specs["middle->tail"].shape == (2, f + SEQ - 1, tm.cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_reference(arch):
    jm = JLM.build(JR.get(arch).config)
    tm = TransformerLM.build(TR.get(arch).config)
    want = jax.eval_shape(jm.init_params, jax.random.key(0))
    have = param_shapes(tm)
    assert all(l.device.type == "meta" for l in tree_leaves(have))
    assert [tuple(l.shape) for l in jax.tree.leaves(
        lm_params_to_numpy_shapes(have))] == [
            tuple(l.shape) for l in jax.tree.leaves(want)]
    assert param_count(have) == sum(int(np.prod(l.shape))
                                    for l in jax.tree.leaves(want))


def lm_params_to_numpy_shapes(tree):
    """The meta tree's shapes as empty numpy stand-ins, in the reference's
    (sorted) leaf order."""
    return tree_map(lambda t: np.broadcast_to(np.zeros((), np.float32),
                                              t.shape), tree)
