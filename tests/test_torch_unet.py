"""The port's U-Net, its layers and the U-shaped (NLS) cut of both model
families against ``repro``, on the CPU.

Params are drawn by the port and converted to the reference's layout
(``repro_torch.interop``: the depthwise weight (C, 1, k, k) becomes HWIO
(k, k, 1, C)); batches are numpy-seeded.  Tolerances, float32 round-off
of convolutions summed in another order: ``sepconv`` within 1e-6,
``upsample2x`` bit-equal; each segment's output (every leaf of the
boundary tree) and the loss within 1e-5, gradients within 1e-4; boundary
specs, parameter counts and leaf layouts equal.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_models import UNET_PAPER as J_UNET_PAPER
from repro.core.partition import cnn_adapter as j_cnn_adapter
from repro.models import layers as JL
from repro.models.cnn import build_unet as j_build_unet
from repro_torch.configs.paper_models import UNET_PAPER
from repro_torch.core.partition import cnn_adapter, detached, leaf_bytes
from repro_torch.interop import params_to_numpy
from repro_torch.models import layers as L
from repro_torch.models.cnn import build_unet, to_nchw, to_nhwc
from repro_torch.tree import tree_leaves, tree_map
from torch_grid_pair import adapters, flat

torch.set_num_threads(2)


def _batch(n=3, size=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((n, size, size, 1)).astype(
        np.float32), "label": (rng.uniform(size=n) < 0.5).astype(np.float32)}


def test_sepconv_matches_repro():
    rng = np.random.default_rng(1)
    p = L.sepconv_init(torch.Generator().manual_seed(0), 5, 7, 3,
                       torch.device("cpu"))
    assert tuple(p["dw"].shape) == (5, 1, 3, 3)
    pj = params_to_numpy(p)
    assert pj["dw"].shape == (3, 3, 1, 5) and pj["pw"].shape == (1, 1, 5, 7)
    x = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    yj = np.asarray(JL.sepconv_apply(pj, x))
    yt = to_nhwc(L.sepconv_apply(p, to_nchw(torch.from_numpy(x)))).numpy()
    np.testing.assert_allclose(yt, yj, atol=1e-6, rtol=1e-6)


def test_upsample2x_is_bit_equal_to_repro():
    x = np.random.default_rng(2).standard_normal((2, 5, 3, 4)).astype(
        np.float32)
    yj = np.asarray(JL.upsample2x(x))
    yt = to_nhwc(L.upsample2x(to_nchw(torch.from_numpy(x)))).numpy()
    assert yt.shape == yj.shape == (2, 10, 6, 4)
    np.testing.assert_array_equal(yt, yj)


@pytest.mark.parametrize("nls", [False, True], ids=["LS", "NLS"])
@pytest.mark.parametrize("arch", ["unet-mini", "densenet-mini"])
def test_segments_loss_and_gradients_match_repro(arch, nls):
    ja, ta = adapters(arch, nls)
    assert ta.seg_names == ja.seg_names and ta.nls == nls
    pt = detached(ta.init(torch.Generator().manual_seed(0),
                          torch.device("cpu")), True)
    pj = params_to_numpy(pt)
    b = _batch()

    def loss_and_segments(p):
        outs, h = [], b["image"]
        for seg in ja.seg_names:
            h = ja.apply_seg(seg, p[seg], h, b, True)
            outs.append(h)
        return ja.loss_from_output(h, b), outs

    (lj, outs_j), gj = jax.jit(jax.value_and_grad(
        loss_and_segments, has_aux=True))(pj)
    ht, outs_t = torch.from_numpy(b["image"]), []
    for seg in ta.seg_names:
        ht = ta.apply_seg(seg, pt[seg], ht, b, True)
        outs_t.append(ht)
    lt = ta.loss_from_output(ht, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
    for hj, ht in zip(outs_j, outs_t):          # boundary trees, then logits
        lj_, lt_ = jax.tree.leaves(hj), tree_leaves(ht)
        assert len(lj_) == len(lt_)
        for a, c in zip(lj_, lt_):
            assert tuple(c.shape) == a.shape and c.is_contiguous()
            np.testing.assert_allclose(c.detach().numpy(), a, atol=1e-5,
                                       rtol=1e-5)
    np.testing.assert_allclose(lt.item(), float(lj), atol=1e-5, rtol=1e-5)
    grads = iter(torch.autograd.grad(lt, tree_leaves(pt)))
    gt = params_to_numpy(tree_map(lambda _: next(grads), pt))
    fj, ft = flat(gj), flat(gt)
    assert list(fj) == list(ft)
    for k in fj:
        np.testing.assert_allclose(ft[k], fj[k], atol=1e-4, rtol=1e-4,
                                   err_msg=str(k))
    pe = ta.per_example_loss(ht, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
    np.testing.assert_allclose(
        pe.detach().numpy(),
        np.asarray(ja.per_example_loss(outs_j[-1], b)), atol=1e-5)


@pytest.mark.parametrize("nls", [False, True], ids=["LS", "NLS"])
@pytest.mark.parametrize("arch", ["unet-mini", "densenet-mini"])
def test_boundary_specs_equal_repro(arch, nls):
    ja, ta = adapters(arch, nls)
    b = _batch()
    sj, st = ja.boundary_specs(b), ta.boundary_specs(b)
    assert list(st) == list(sj) == (["front->middle", "middle->tail"] if nls
                                    else ["front->middle"])
    for k in sj:
        lj, lt = jax.tree.leaves(sj[k]), tree_leaves(st[k])
        assert [tuple(l.shape) for l in lt] == [l.shape for l in lj]
        assert all(l.device.type == "meta" for l in lt)


def test_paper_unet_boundary_and_params_equal_repro():
    """``UNET_PAPER`` at 768^2, sized on the meta device: 2,730,457 params
    and a 5-leaf boundary of 289.8 MB per image (the 48^2 x 728 hidden and
    four skips), plus a 151.0 MB ``middle->tail`` leg under NLS."""
    b = {"image": np.zeros((1, 768, 768, 1), np.float32),
         "label": np.zeros((1,), np.float32)}
    ta = cnn_adapter(build_unet(UNET_PAPER, nls=True))
    ja = j_cnn_adapter(j_build_unet(J_UNET_PAPER, nls=True))
    pt = ta.init(None, torch.device("meta"))
    shapes_j = jax.eval_shape(ja.init, jax.random.key(0))
    assert L.param_count(pt) == 2_730_457 == sum(
        int(np.prod(l.shape)) for l in jax.tree.leaves(shapes_j))
    st, sj = ta.boundary_specs(b, pt), ja.boundary_specs(b)
    fm = [tuple(l.shape) for l in tree_leaves(st["front->middle"])]
    assert fm == [l.shape for l in jax.tree.leaves(sj["front->middle"])] \
        == [(1, 48, 48, 728), (1, 768, 768, 64), (1, 384, 384, 128),
            (1, 192, 192, 256), (1, 96, 96, 512)]
    assert leaf_bytes(st["front->middle"]) == 289_824_768
    assert leaf_bytes(st["middle->tail"]) == 150_994_944
