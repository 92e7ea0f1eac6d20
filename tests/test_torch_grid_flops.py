"""The port's FLOP accounting (paper Tables 5/6) against ``repro``'s.

The reference counts a segment's forward FLOPs with XLA's
``cost_analysis``; the port with ``FlopCounterMode`` on meta tensors,
which counts convolutions and matmuls only.  Measured on ``DENSENET_MINI``
and ``UNET_MINI`` at 8 x 32^2, the port's front and middle read 0.75-1.11
of the reference's (the U-Net front, one encoder block at 16 channels,
is the lowest: its GroupNorm and ReLU work, which XLA counts, is a
quarter of it), so they are held within 30%; the NLS tail (a head whose
norm and pooling XLA counts and the port does not) is held only to under
1% of the model in both counts.  Per-epoch server and client TFLOPs of
every row are held to the same 30%; ``averaging_mflops`` comes from
parameter counts and is exactly equal; the orderings of
``tests/test_comm_flops.py`` hold on the port's counts.
"""

import functools

import numpy as np
import pytest

from repro.core.flops import flops_per_epoch as j_flops_per_epoch
from repro.core.flops import segment_fwd_flops as j_segment_fwd_flops
from repro_torch.core.flops import flops_per_epoch, segment_fwd_flops
from repro_torch.core.partition import cnn_adapter
from repro_torch.models.cnn import DenseNetConfig, build_densenet
from torch_grid_pair import adapters, load

BS = 8
N_TRAIN = [40, 16, 24, 16, 24]
ROWS = load("benchmarks/repro_tables.py").ROWS
BATCH = {"image": np.zeros((BS, 32, 32, 1), np.float32),
         "label": np.zeros((BS,), np.float32)}


CUTS = [("densenet-mini", False), ("densenet-mini", True),
        ("unet-mini", False), ("unet-mini", True)]


@functools.lru_cache(maxsize=None)
def counted(arch, nls):
    ja, ta = adapters(arch, nls)
    return (ja, ta, j_segment_fwd_flops(ja, BATCH),
            segment_fwd_flops(ta, BATCH))


@pytest.mark.parametrize("arch, nls", CUTS)
def test_segment_flops_within_stated_tolerance(arch, nls):
    _, ta, fj, ft = counted(arch, nls)
    assert list(ft) == list(fj) == list(ta.seg_names)
    for seg in ("front", "middle"):
        assert 0.7 <= ft[seg] / fj[seg] <= 1.3, (seg, ft[seg] / fj[seg])
    if nls:
        assert ft["tail"] < 0.01 * sum(ft.values())
        assert fj["tail"] < 0.01 * sum(fj.values())


@pytest.mark.parametrize("arch", ["densenet-mini", "unet-mini"])
@pytest.mark.parametrize("label, method, nls", ROWS, ids=[r[0] for r in ROWS])
def test_averaging_flops_equal_and_compute_close(label, method, nls, arch):
    ja, ta, fj, ft = counted(arch, nls)
    pj = j_flops_per_epoch(method, ja, BATCH, N_TRAIN, BS, seg_fwd=fj)
    pt = flops_per_epoch(method, ta, BATCH, N_TRAIN, BS, seg_fwd=ft)
    assert pt.averaging_mflops == pj.averaging_mflops
    for a, b in [(pt.server_tflops, pj.server_tflops),
                 (pt.avg_client_tflops, pj.avg_client_tflops)]:
        assert (a == b == 0) or 0.7 <= a / b <= 1.3


def test_orderings_of_the_reference_hold():
    """On the thin-client DenseNet of ``tests/test_comm_flops.py`` (cut
    after the stem, like the paper's "first 4 of 121 layers")."""
    ta = cnn_adapter(build_densenet(DenseNetConfig(
        growth=8, blocks=(3, 6), stem_ch=8, cut_layer=1)))
    batch = {"image": np.zeros((BS, 16, 16, 1), np.float32),
             "label": np.zeros((BS,), np.float32)}
    n_train = [48, 32, 48, 16, 32]
    seg = segment_fwd_flops(ta, batch)
    f = {m: flops_per_epoch(m, ta, batch, n_train, BS, seg_fwd=seg)
         for m in ("centralized", "fl", "sl_ac", "sflv2_ac", "sflv3_ac")}
    total_split = (f["sl_ac"].server_tflops
                   + f["sl_ac"].avg_client_tflops * len(n_train))
    assert abs(total_split - f["centralized"].server_tflops) \
        / f["centralized"].server_tflops < 1e-6
    assert f["fl"].avg_client_tflops > 4 * f["sl_ac"].avg_client_tflops
    assert f["sl_ac"].server_tflops > f["sl_ac"].avg_client_tflops
    assert f["sflv3_ac"].averaging_mflops > f["sflv2_ac"].averaging_mflops
    assert f["fl"].averaging_mflops > f["sflv2_ac"].averaging_mflops
