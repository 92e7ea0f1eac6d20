"""The plain references: their FLOP and byte counts (each family's, found
by the configuration's ``family``) at the cells' sizes and the LM mini's,
the int8 link against the program's plain version, and the SplitFedv3
steps against the program's at the mini models' sizes on the CPU."""

import json

import pytest
import torch

from conftest import LM_MINI_TRAFFIC, MINI_CONFIGS, ROOT, mini_parts

from perfbench import harness
from perfbench.reference import train as R


def _cfg(name):
    if name == "lm-dense-mini":
        return MINI_CONFIGS["lm_dense"], LM_MINI_TRAFFIC
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text()), None


# the LM mini (d 64, ff 128, 4 heads of 16, 2 KV heads, vocab 128, 16
# positions) a layer: q, k, v, o 2*16*64*(64+32+32+64); scores and values
# 2 * 2*4*16*16*16; SwiGLU 3 * 2*16*64*128; two layers and the head
# 2*16*64*128
LM_MINI_FLOPS = 2 * (2 * 16 * 64 * 192 + 2 * 2 * 4 * 16 ** 3
                     + 3 * 2 * 16 * 64 * 128) + 2 * 16 * 64 * 128


@pytest.mark.parametrize("name, flops", [
    ("densenet121-paper-224", 5_508_925_440),
    ("unet-xception-paper-768", 112_082_153_472),
    ("lm-dense-mini", LM_MINI_FLOPS)])
def test_forward_flops(name, flops):
    cfg, traffic = _cfg(name)
    assert harness.family(cfg, "reference").forward_flops(
        cfg, traffic) == flops


@pytest.mark.parametrize("name, images, nbytes", [
    # 80 x 56 x 56 x 160 f32 read once and written once
    ("densenet121-paper-224", 80, 2 * 80 * 56 * 56 * 160 * 4),
    # the five leaves, 768^2 x 64 + 384^2 x 128 + 192^2 x 256 + 96^2 x 512
    # + 48^2 x 728 = 72,456,192 f32 (289.8 MB) an image, read and written
    ("unet-xception-paper-768", 10, 2 * 10 * 72_456_192 * 4),
    # the same leaves in bfloat16 move half the bytes
    ("unet-xception-paper-768-bf16", 10, 2 * 10 * 72_456_192 * 2),
    # six sequences of 16 positions of 64 f32 values
    ("lm-dense-mini", 6, 2 * 6 * 16 * 64 * 4)])
def test_link_bytes(name, images, nbytes):
    if name.endswith("-bf16"):
        cfg, traffic = _cfg(name[:-5])
        cfg = dict(cfg, precision="bf16")
    else:
        cfg, traffic = _cfg(name)
    assert harness.family(cfg, "reference").link_bytes(
        cfg, traffic, images) == nbytes


def test_epoch_batches_are_the_programs():
    """The reference's epoch takes the program's batches in its order:
    each hospital shuffled in turn by one generator, whole batches, the
    short hospitals wrapping around."""
    import numpy as np

    from repro_torch.core.strategies.base import np_batches

    sizes, b = [9, 4, 7], 2
    data = [{"label": np.arange(n)} for n in sizes]
    rng = np.random.default_rng(2 ** 40 + 1)
    want = [np_batches(d, b, rng) for d in data]
    steps = R.epoch_batches(sizes, b, np.random.default_rng(2 ** 40 + 1))
    assert len(steps) == 4
    for s, step in enumerate(steps):
        assert [h for h, _ in step] == [0, 1, 2]
        for h, idx in step:
            w = want[h][s % len(want[h])]["label"]
            assert np.array_equal(idx, w)


def test_int8_link_equals_the_programs_plain_version():
    from repro_torch.kernels.act_compress.ref import roundtrip_ref

    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 160, 7, 5), generator=g) * torch.rand(
        (4, 1, 7, 5), generator=g)
    x[0, :, 0, 0] = 0.0                                  # an all-zero row
    rows = x.permute(0, 2, 3, 1).reshape(-1, 160)
    want = roundtrip_ref(rows).reshape(4, 7, 5, 160).permute(0, 3, 1, 2)
    assert torch.equal(R.int8_link(x), want)
    xr = x.clone().requires_grad_(True)
    R.int8_link(xr).sum().backward()
    assert torch.equal(xr.grad, torch.ones_like(x))      # straight through


def test_int8_link_on_token_rows_equals_the_programs():
    """The LM's cut: a row is one token's hidden state (the last axis), as
    the program's ``compress_boundary`` takes it."""
    from repro_torch.kernels.act_compress.ops import compress_boundary

    g = torch.Generator().manual_seed(5)
    x = torch.randn((3, 7, 64), generator=g) * torch.rand((3, 7, 1),
                                                          generator=g)
    x[1, 2] = 0.0                                        # an all-zero row
    assert torch.equal(R.int8_link(x, -1), compress_boundary(x))


@pytest.mark.parametrize("family, traffic", [
    ("densenet", "sflv3-tenth-b16"), ("unet", "sflv3-160th-b2")])
def test_reference_follows_the_program(family, traffic, cpu_threads):
    _, cfg, traffic, limits = mini_parts(family, traffic)
    s = harness.set_up(cfg, traffic, 2 ** 33 + 7, torch.device("cpu"))
    ref = harness.reference(cfg, traffic, s, torch.device("cpu"))
    got = harness.compare(s["first"], ref, s["init"])
    # the same arithmetic on the CPU, in another order: far inside the
    # card's limits
    assert got["loss_gap"] < 1e-5 and got["val_gap"] < 1e-5
    assert got["moment_gap"] < 1e-4 and got["update_gap"] < 1e-3
    assert all(got[k] <= limits[k] for k in harness.CHECKS)
