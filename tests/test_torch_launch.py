"""The launch layer (``repro_torch.launch.mesh``, ``specs``,
``train.get_axes_tree`` and the models' ``init_axes``) against ``repro``,
on the CPU, nothing allocated:

  * the logical-axes tree of every registry config's SMOKE model, and of
    the tiny DenseNet (``tests/test_system.py``'s) and U-Net (``UNET_MINI``;
    LS and NLS), equal to the reference's
    ``init`` leaf for leaf: the same keys, and each leaf's names equal
    (a convolution's through the port's OIHW layout: the reference's
    HWIO names permuted);
  * ``spec_for`` against the reference's on a ``FakeMesh`` of (16, 16)
    and of (2, 16, 16), for every leaf of every registry config's FULL
    axes tree (``get_axes_tree`` of ``init_sflv3_params`` with 16
    hospitals in both packages; the reference's through
    ``jax.eval_shape``): equal spec for spec, and each leaf's shape equal;
    plus the four cases of ``tests/test_launch.py``;
  * ``cache_specs`` for ``decode_32k`` and ``long_500k`` equal to the
    reference's leaf for leaf (the reference's tests' config and every
    SMOKE config; the attention caches' index a 0-d int32 tensor), and
    the batch specs;
  * ``make_production_mesh`` touches nothing on import and builds the
    (16, 16) and (2, 16, 16) meshes over a fake process group, in a
    subprocess.
"""

import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_models import UNET_MINI as J_UNET_MINI
from repro.configs.registry import REGISTRY as J_REGISTRY
from repro.launch import mesh as JMESH
from repro.launch import specs as JSPECS
from repro.launch.train import get_axes_tree as j_get_axes_tree
from repro.launch.train import init_sflv3_params as j_init_sflv3_params
from repro.models.cnn import DenseNetConfig as JDenseNetConfig
from repro.models.cnn import build_densenet as j_build_densenet
from repro.models.cnn import build_unet as j_build_unet
from repro.models.transformer import ModelConfig as JModelConfig
from repro.models.transformer import TransformerLM as JTransformerLM
from repro_torch.configs.paper_models import UNET_MINI
from repro_torch.configs.registry import REGISTRY
from repro_torch.launch import mesh as MESH
from repro_torch.launch import specs as SPECS
from repro_torch.launch.train import get_axes_tree
from repro_torch.models.cnn import DenseNetConfig, build_densenet, build_unet
from repro_torch.models.transformer import ModelConfig, TransformerLM
from torch_grid_pair import TINY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_HOSPITALS = 16


class FakeMesh:
    """Duck-typed mesh (the reference tests' own): no devices needed."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


MESHES = [FakeMesh((16, 16), ("data", "model")),
          FakeMesh((2, 16, 16), ("pod", "data", "model"))]


def _is_axes(v):
    return isinstance(v, tuple) and all(isinstance(x, (str, type(None)))
                                        for x in v)


def _flat(tree, path=()):
    """{path: leaf} of an axes (or shapes) tree, dict keys sorted."""
    if _is_axes(tree) or not isinstance(tree, (dict, list, tuple)):
        return {path: tree}
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    return {p: v for k, t in items for p, v in _flat(t, path + (k,)).items()}


def _flat_dict(tree, path=()):
    """{path: leaf} through dicts only (a spec tree's leaves are
    tuples)."""
    if not isinstance(tree, dict):
        return {path: tree}
    return {p: v for k, t in sorted(tree.items())
            for p, v in _flat_dict(t, path + (k,)).items()}


def _hwio(axes):
    """A port leaf's names in the reference's layout (OIHW -> HWIO)."""
    return tuple(axes[i] for i in (2, 3, 1, 0)) if len(axes) == 4 else axes


def _same_axes(j_axes, t_axes, conv=False):
    fj, ft = _flat(j_axes), _flat(t_axes)
    assert fj.keys() == ft.keys()
    for k in fj:
        assert tuple(fj[k]) == (_hwio(ft[k]) if conv else ft[k]), k


def _j_lm(cfg):
    return JTransformerLM.build(cfg)


@pytest.mark.parametrize("arch", list(REGISTRY))
def test_smoke_axes_trees_match(arch):
    j = _j_lm(J_REGISTRY[arch].smoke)
    t = TransformerLM.build(REGISTRY[arch].smoke)
    _, j_axes = j.init(jax.random.key(0))
    _same_axes(j_axes, t.init_axes())


@pytest.mark.parametrize("name, nls", [("densenet", False),
                                       ("densenet", True), ("unet", False),
                                       ("unet", True)])
def test_cnn_axes_trees_match(name, nls):
    if name == "densenet":
        j = j_build_densenet(JDenseNetConfig(**TINY), nls=nls)
        t = build_densenet(DenseNetConfig(**TINY), nls=nls)
    else:
        j = j_build_unet(J_UNET_MINI, nls=nls)
        t = build_unet(UNET_MINI, nls=nls)
    _, j_axes = j.init(jax.random.key(0))
    _same_axes(j_axes, t.init_axes(), conv=True)
    # the axes name each leaf of the params, and count its dims
    shapes = _flat(t.init_params(None, torch.device("meta")))
    for k, axes in _flat(t.init_axes()).items():
        assert len(axes) == shapes[k].dim()


@pytest.mark.parametrize("arch", list(REGISTRY))
def test_full_config_specs_match(arch):
    """Every leaf of the full config's SFLv3 param tree: shape and axes
    equal, and ``spec_for`` equal on both production mesh shapes."""
    jm = _j_lm(J_REGISTRY[arch].config)
    j_shapes, j_axes = j_get_axes_tree(
        lambda k: j_init_sflv3_params(jm, k, N_HOSPITALS),
        jax.random.key(0))
    t_shapes, t_axes = get_axes_tree(
        TransformerLM.build(REGISTRY[arch].config), N_HOSPITALS)
    fja, fta = _flat(j_axes), _flat(t_axes)
    fjs, fts = _flat(j_shapes), _flat(t_shapes)
    assert fja.keys() == fta.keys() == fjs.keys() == fts.keys()
    for k in fja:
        assert tuple(fja[k]) == fta[k], k
        assert tuple(fjs[k].shape) == tuple(fts[k].shape), k
        assert fts[k].device.type == "meta"
        for mesh in MESHES:
            shape = tuple(fts[k].shape)
            assert MESH.spec_for(fta[k], shape, mesh) == tuple(
                JMESH.spec_for(tuple(fja[k]), shape, mesh)), (k, shape)
    sh = MESH.tree_shardings(t_axes, t_shapes, MESHES[0])
    leaf = sh["middle"]["final_norm"]["scale"]
    assert leaf.spec == tuple(JMESH.spec_for(("embed",), (
        REGISTRY[arch].config.d_model,), MESHES[0]))


def test_spec_for_rules():
    """``tests/test_launch.py``'s four cases, in both packages."""
    mesh, pod = MESHES
    cases = [((("embed", "ff"), (1024, 4096)), mesh, ("data", "model")),
             ((("embed", "vocab"), (2304, 122753)), mesh, ("data",)),
             ((("ff", "ff"), (4096, 4096)), mesh, ("model",)),
             ((("clients", "embed", "ff"), (16, 1024, 4096)), mesh,
              ("data", None, "model")),
             ((("clients", "embed"), (32, 7168)), pod, ("data", "pod"))]
    for (axes, shape), m, want in cases:
        assert MESH.spec_for(axes, shape, m) == want
        assert MESH.spec_for(axes, shape, m) == tuple(
            JMESH.spec_for(axes, shape, m))
    assert MESH.dp_axes(pod) == JMESH.dp_axes(pod) == ("pod", "data")
    assert MESH.RULES == JMESH.RULES
    assert MESH.batch_sharding(pod, 3).spec == (("pod", "data"), None, None)
    assert MESH.batch_sharding(mesh, 2).spec == ("data", None)


def _tiny_cfg(cls):
    return cls(name="t", arch_type="dense", n_layers=2, d_model=64,
               n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
               cut_layer=1, remat=False)


def _cache_pairs(j_model, t_model, shape, mesh):
    j_shapes, j_specs = JSPECS.cache_specs(j_model, shape, mesh,
                                           as_pspec=True)
    t_shapes, t_specs = SPECS.cache_specs(t_model, shape, mesh,
                                          as_pspec=True)
    js, jl = _flat_dict(j_specs), _flat_dict(j_shapes)
    ts, tl = _flat_dict(t_specs), _flat_dict(t_shapes)
    assert js.keys() == ts.keys() == jl.keys() == tl.keys()
    return [(k, tuple(js[k]), ts[k], jl[k], tl[k]) for k in js]


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_cache_specs_match(shape):
    for mesh in MESHES:
        models = [(_j_lm(_tiny_cfg(JModelConfig)),
                   TransformerLM.build(_tiny_cfg(ModelConfig)))]
        models += [(_j_lm(J_REGISTRY[a].smoke),
                    TransformerLM.build(REGISTRY[a].smoke))
                   for a in REGISTRY]
        for jm, tm in models:
            for k, js, ts, jl, tl in _cache_pairs(jm, tm, shape, mesh):
                assert js == ts, (k, js, ts)
                assert tl.device.type == "meta", k
                if k[-1] == "index":
                    # a 0-d int32 tensor as the reference's; the layers of
                    # a port run share one, where the reference's stacked
                    # run carries one a layer
                    assert tl.shape == () and tl.dtype == torch.int32, k
                    assert jl.dtype == np.int32 and len(jl.shape) <= 1, k
                else:
                    assert tuple(jl.shape) == tuple(tl.shape), k
    # the reference tests' own reading: k/v batch on data, seq on model
    # (decode_32k); batch replicated, seq over every axis (long_500k)
    kv = [(js, tl) for _k, js, _ts, _jl, tl in _cache_pairs(
        _j_lm(_tiny_cfg(JModelConfig)), TransformerLM.build(
            _tiny_cfg(ModelConfig)), shape, MESHES[0])
        if isinstance(tl, torch.Tensor) and tl.dim() == 5]
    assert kv
    if shape == "decode_32k":
        assert all(s[1] == "data" and s[2] == "model" for s, _ in kv)
    else:
        assert all(s[1] is None and s[2] == ("data", "model")
                   for s, _ in kv)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k",
                                   "decode_32k", "long_500k"])
def test_batch_specs_match(shape, monkeypatch):
    # the reference wraps its specs in NamedShardings, which need a real
    # mesh: keep the spec alone
    monkeypatch.setattr(JSPECS, "NamedSharding",
                        lambda mesh, spec: types.SimpleNamespace(spec=spec))
    arch = "internvl2-76b"              # has a frontend
    for mesh in MESHES:
        if shape in ("decode_32k", "long_500k"):
            (jt, jp), (jts, jps) = JSPECS.decode_token_specs(shape, mesh)
            (tt, tp), (tts, tps) = SPECS.decode_token_specs(shape, mesh)
            assert tuple(tt.shape) == jt.shape and tts.spec == tuple(
                jts.spec)
            continue
        fn = "train_batch_specs" if shape == "train_4k" else \
            "prefill_batch_specs"
        jb, jsh = getattr(JSPECS, fn)(J_REGISTRY[arch].config, shape, mesh)
        tb, tsh = getattr(SPECS, fn)(REGISTRY[arch].config, shape, mesh)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert tuple(tb[k].shape) == jb[k].shape
            assert tb[k].device.type == "meta"
            assert tsh[k].spec == tuple(jsh[k].spec)


def test_production_mesh_on_a_fake_group():
    """``make_production_mesh`` needs a 256- or 512-rank group: a fake
    one in a fresh process (importing the module touches nothing)."""
    code = (
        "import torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "from repro_torch.launch.mesh import make_production_mesh, "
        "placements\n"
        "for multi, n, shape, names in ((False, 256, (16, 16), "
        "('data', 'model')), (True, 512, (2, 16, 16), "
        "('pod', 'data', 'model'))):\n"
        "    dist.init_process_group('fake', store=FakeStore(), rank=0, "
        "world_size=n)\n"
        "    try:\n"
        "        m = make_production_mesh(multi_pod=multi, "
        "device_type='cpu')\n"
        "        assert tuple(m.shape) == shape, m.shape\n"
        "        assert m.mesh_dim_names == names\n"
        "        p = placements(('data', None, 'model'), m)\n"
        "        assert [type(x).__name__ for x in p][-2:] == "
        "['Shard', 'Shard']\n"
        "    finally:\n"
        "        dist.destroy_process_group()\n"
        "print('MESH_OK')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": "src"})
    assert "MESH_OK" in out.stdout, out.stderr[-2000:]
