"""The port's DenseNet, adapter, optimizer and metrics against ``repro`` on
the CPU, at ``DENSENET_MINI`` / 32x32 (whose stem conv and max-pool pad
asymmetrically exactly as the 224^2 paper model does).

Params are drawn once by the port and converted to the reference's layout
(``repro_torch.interop``); the batch is numpy-seeded.  Tolerances, each float32 round-off of different
summation orders: segment outputs and the cut tensor <= 1e-5, loss <= 1e-5,
gradients <= 1e-4, 20 Adam steps <= 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import optim as JO
from repro.configs.paper_models import DENSENET121_PAPER as J_PAPER
from repro.configs.paper_models import DENSENET_MINI as J_MINI
from repro.core.partition import cnn_adapter as j_cnn_adapter
from repro.models.cnn import build_densenet as j_build
from repro.train import metrics as JM
from repro_torch import optim as TO
from repro_torch.configs.paper_models import DENSENET121_PAPER, DENSENET_MINI
from repro_torch.core.partition import cnn_adapter, detached
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models.cnn import build_densenet
from repro_torch.models.layers import num_groups, same_pads
from repro_torch.train import metrics as TM
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)


def _batch(n=4, size=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((n, size, size, 1)).astype(np.float32),
            "label": (rng.uniform(size=n) < 0.5).astype(np.float32)}


def _pair():
    ja = j_cnn_adapter(j_build(J_MINI))
    ta = cnn_adapter(build_densenet(DENSENET_MINI))
    pt = ta.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    return ja, ta, params_to_numpy(pt), pt


def _flat(tree, path=()):
    """{path: numpy leaf}, dict keys sorted (jax.tree's order)."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _flat(tree[k], path + (k,)).items()}
    return {path: np.asarray(tree)}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def test_same_padding_and_groups_follow_xla():
    assert same_pads(224, 7, 2) == (2, 3)       # stem conv
    assert same_pads(112, 3, 2) == (0, 1)       # stem max-pool
    assert same_pads(56, 3, 1) == (1, 1)
    assert [num_groups(c) for c in (1, 12, 24, 36, 160)] == [1, 6, 8, 6, 8]


def test_segments_loss_and_gradients_match_repro():
    ja, ta, pj, pt = _pair()
    b = _batch()

    def loss_and_segments(p):
        outs, h = [], b["image"]
        for seg in ja.seg_names:
            h = ja.apply_seg(seg, p[seg], h, b, True)
            outs.append(h)
        return ja.loss_from_output(h, b), outs

    (lj, outs_j), gj = jax.jit(jax.value_and_grad(
        loss_and_segments, has_aux=True))(pj)
    pt = detached(pt, True)
    ht, outs_t = torch.from_numpy(b["image"]), []
    for seg in ta.seg_names:
        ht = ta.apply_seg(seg, pt[seg], ht, b, True)
        outs_t.append(ht)
    lt = ta.loss_from_output(ht, _tb(b))
    for hj, ht in zip(outs_j, outs_t):     # the first one is the cut tensor
        assert tuple(ht.shape) == hj.shape and ht.is_contiguous()
        _close(hj, ht.detach().numpy(), 1e-5)
    _close(lj, lt.item(), 1e-5)
    grads = iter(torch.autograd.grad(lt, tree_leaves(pt)))
    gt = params_to_numpy(tree_map(lambda _: next(grads), pt))
    fj, ft = _flat(gj), _flat(gt)
    assert list(fj) == list(ft)
    for k in fj:
        _close(fj[k], ft[k], 1e-4)


def test_boundary_specs_equal_repro():
    ja, ta, _, _ = _pair()
    b = _batch()
    sj, st = ja.boundary_specs(b), ta.boundary_specs(b)
    assert list(sj) == list(st)
    for k in sj:
        assert tuple(st[k].shape) == sj[k].shape and st[k].device.type == "meta"


def test_u_shaped_split_raises_naming_its_roadmap_item():
    """The U-shaped split builds and matches the reference: the same three
    segments and units, each segment's output within 1e-5 from converted
    params, and the same boundary specs, ``middle->tail`` included."""
    ja = j_cnn_adapter(j_build(J_MINI, nls=True))
    ta = cnn_adapter(build_densenet(DENSENET_MINI, nls=True))
    assert ta.nls and ta.seg_names == ja.seg_names == ("front", "middle",
                                                       "tail")
    pt = ta.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    pj = params_to_numpy(pt)
    assert list(pt["tail"]) == ["head"]
    b = _batch()
    hj, ht = b["image"], torch.from_numpy(b["image"])
    with torch.no_grad():
        for seg in ja.seg_names:
            hj = ja.apply_seg(seg, pj[seg], hj, b, True)
            ht = ta.apply_seg(seg, pt[seg], ht, b, True)
            _close(hj, ht.numpy(), 1e-5)
    sj, st = ja.boundary_specs(b), ta.boundary_specs(b)
    assert list(sj) == list(st) == ["front->middle", "middle->tail"]
    for k in sj:
        assert tuple(st[k].shape) == sj[k].shape


def test_paper_densenet_cut_tensor_shape():
    """DenseNet-121 at 224^2 cut after 4 units: (B, 56, 56, 160), sized on
    the meta device (no compute)."""
    b = {"image": np.zeros((16, 224, 224, 1), np.float32),
         "label": np.zeros((16,), np.float32)}
    spec = cnn_adapter(build_densenet(DENSENET121_PAPER)).boundary_specs(b)
    jspec = j_cnn_adapter(j_build(J_PAPER)).boundary_specs(b)
    assert tuple(spec["front->middle"].shape) == \
        jspec["front->middle"].shape == (16, 56, 56, 160)


def test_params_roundtrip_through_interop():
    ja, _, pj, pt = _pair()
    # conv weights: OIHW in the port, HWIO in the reference
    assert tuple(pt["front"]["stem"]["c"]["w"].shape) == (24, 1, 7, 7)
    assert pj["front"]["stem"]["c"]["w"].shape == (7, 7, 1, 24)
    shapes_j = jax.tree.map(lambda s: np.empty(s.shape, s.dtype),
                            jax.eval_shape(ja.init, jax.random.key(0)))
    assert {k: v.shape for k, v in _flat(shapes_j).items()} == \
        {k: v.shape for k, v in _flat(pj).items()}
    back = _flat(params_to_numpy(params_from_jax(pj)))
    for k, v in _flat(pj).items():
        np.testing.assert_array_equal(v, back[k])


def test_adam_matches_repro_over_20_steps():
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p, i=i: (rng.standard_normal(p.shape) *
                                          (i + 1)).astype(np.float32), params)
             for i in range(20)]
    jo, to = JO.adam(1e-2), TO.adam(1e-2)
    pj, pt = params, tree_map(torch.from_numpy, params)
    sj, st = jo.init(pj), to.init(pt)
    for g in grads:
        uj, sj = jo.update(g, sj, pj)
        pj = JO.apply_updates(pj, uj)
        ut, st = to.update(tree_map(torch.from_numpy, g), st)
        pt = TO.apply_updates(pt, ut)
    assert st["step"] == int(sj["step"]) == 20
    for a, c in zip(jax.tree.leaves(pj), tree_leaves(pt)):
        _close(a, c.numpy(), 1e-6)


def test_metrics_copy_agrees():
    rng = np.random.default_rng(3)
    labels = (rng.uniform(size=200) < 0.3).astype(np.float32)
    scores = np.round(rng.uniform(size=200), 2)      # ties on purpose
    assert TM.all_metrics(labels, scores) == JM.all_metrics(labels, scores)


def test_bce_is_finite_for_large_logits():
    from repro_torch.models.cnn import bce_loss
    from repro.models.cnn import bce_loss as j_bce
    logits = np.array([[-80.0], [0.0], [90.0]], np.float32)
    labels = np.array([1.0, 0.0, 0.0], np.float32)
    _close(j_bce(jnp.asarray(logits), jnp.asarray(labels)),
           bce_loss(torch.from_numpy(logits), torch.from_numpy(labels)).item(),
           1e-6)
