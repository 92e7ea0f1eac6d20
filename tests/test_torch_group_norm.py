"""K9, GroupNorm fused with the ReLU after it (``kernels/group_norm``), in
ATen's CUDA arithmetic to the bit.

On the CPU: the plain version (``ref.py``: ATen's 512 Welford chains a row,
its warp trees and fused apply, vectorised) bit-equal to a line-by-line
scalar transcription of ATen's ``RowwiseMomentsCUDAKernel`` at rows of
512 or more elements (ragged last steps) and under 512 (one warp of
chains); against ATen's CPU ``F.relu(F.group_norm(...))`` within 2e-6 of
the output's scale (another algorithm) and against float64 within 2e-6 of
each value (f32 Welford), in both layouts; a row's chains for 16, 80 and
640 rows; the autograd Function's backward against ATen's pair (ReLU's
in a node of its own, no gradient made for the statistics) and its
``vmap`` fold against a per-example loop (equal: GroupNorm is per
example); and ``groupnorm_relu_apply`` on the CPU bit for bit today's ATen
pair.

On the card (skipped without one): K9 bit-equal to ATen's
``F.relu(F.group_norm(...))`` (and its mean and rstd to
``native_group_norm``'s) at the U-Net's 768^2 x 64 shapes and
DenseNet-121's middle, f32 and bf16 (through f32, as the model runs it),
both layouts; the channels_last copy equal to ``Tensor.contiguous``'s;
under a CUDA graph capture, two replays bit-equal to each other and to
the eager launch.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.group_norm import group_norm as GN
from repro_torch.kernels.group_norm import ops as O
from repro_torch.kernels.group_norm import ref as R
from repro_torch.models import layers as L

torch.set_num_threads(2)

SHAPES = [((2, 16, 5, 6), 8), ((3, 24, 4, 4), 8), ((2, 12, 3, 3), 4),
          ((1, 40, 9, 7), 8), ((2, 64, 12, 11), 8)]


def _inputs(shape, cl, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    if cl:
        x = x.to(memory_format=torch.channels_last)
    gamma = torch.randn(shape[1], generator=g)
    beta = torch.randn(shape[1], generator=g)
    return x, gamma, beta


def _f64(x, gamma, beta, groups, eps=1e-5):
    return F.relu(F.group_norm(x.double(), groups, gamma.double(),
                               beta.double(), eps))


# -- ATen's RowwiseMomentsCUDAKernel, line by line, one scalar at a time ----

f32 = np.float32


def _fma(a, b, c):
    return f32(np.float64(a) * np.float64(b) + np.float64(c))


def _reduce(acc, data):                       # WelfordOps::reduce
    mean, m2, n = acc
    new_nf = f32(n + 1)
    delta = f32(data - mean)
    new_mean = f32(mean + f32(delta / new_nf))
    return new_mean, _fma(delta, f32(data - new_mean), m2), n + 1


def _combine(a, b):                           # WelfordOps::combine
    if a[2] == 0:
        return b
    if b[2] == 0:
        return a
    delta = f32(b[0] - a[0])
    count = f32(a[2] + b[2])
    nb_over_n = f32(f32(b[2]) / count)
    return (_fma(delta, nb_over_n, a[0]),
            _fma(f32(f32(delta * delta) * f32(a[2])), nb_over_n,
                 f32(a[1] + b[1])), count)


def _warp_reduce(vals):                       # cuda_utils::WarpReduce
    vals = list(vals)
    for off in (16, 8, 4, 2, 1):
        # __shfl_down_sync: a lane past the warp reads its own value
        vals = [_combine(v, vals[i + off] if i + off < 32 else v)
                for i, v in enumerate(vals)]
    return vals


def _aten_moments(row, eps=1e-5):
    """(mean, rstd) of one row as RowwiseMomentsCUDAKernel computes them."""
    threads = 32 if len(row) < 512 else 512
    acc = []
    for t in range(threads):
        v = (f32(0), f32(0), 0)
        for j in range(t, len(row), threads):
            v = _reduce(v, row[j])
        acc.append(v)
    warps = [_warp_reduce(acc[w:w + 32])[0] for w in range(0, threads, 32)]
    if threads > 32:                          # cuda_utils::BlockReduce
        warps = _warp_reduce(warps + [(f32(0), f32(0), 0)] * (32 - len(warps)))
    mean, m2, n = warps[0]
    var = f32(m2 / f32(n))
    return mean, f32(1) / np.sqrt(f32(var + f32(eps)), dtype=np.float32)


@pytest.mark.parametrize("length", [1100, 512, 300, 37])
def test_plain_version_is_atens_chains(length):
    """The vectorised chains and trees of ``ref.py`` against the scalar
    transcription: mean bit-equal; rstd within an ulp (the transcription
    takes 1 / sqrt where the card's rsqrtf rounds its own way)."""
    x = (torch.randn(1, 2, length, 1, generator=torch.Generator()
                     .manual_seed(length)) * 3 + 1).float()
    parts = R.warp_partials_ref(x, 2)
    assert parts.shape == (2, 16 if length >= 512 else 1, 3)
    mean, rstd = R.merge_ref(parts, 1e-5)
    for g in range(2):
        m, r = _aten_moments(x[0, g, :, 0].numpy())
        assert mean[g].item() == m
        assert abs(rstd[g].item() - r) <= 2.0 ** -23 * r


@pytest.mark.parametrize("cl", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_plain_version_against_aten_and_float64(shape, groups, cl):
    x, gamma, beta = _inputs(shape, cl)
    y, mean, rstd = GN.group_norm_relu_fwd(x, gamma, beta, groups, 1e-5)
    assert y.is_contiguous() and y.dtype == x.dtype
    assert mean.shape == rstd.shape == (shape[0], groups)
    aten = F.relu(F.group_norm(x, groups, gamma, beta, 1e-5))
    assert (y - aten).abs().max() <= 2e-6 * aten.abs().max()
    want = _f64(x, gamma, beta, groups)
    assert ((y.double() - want).abs() <= 2e-6 * (1 + want.abs())).all()
    xr = x.double().reshape(shape[0], groups, -1)
    assert torch.allclose(mean.double(), xr.mean(-1), rtol=1e-6, atol=1e-7)
    assert torch.allclose(rstd.double(), 1 / torch.sqrt(
        xr.var(-1, unbiased=False) + 1e-5), rtol=1e-6)


@pytest.mark.parametrize("cl", [False, True], ids=["nchw", "channels_last"])
def test_plain_version_in_bf16_reads_f32(cl):
    """bf16 x: the statistics and y of its f32 values, y rounded once to
    bf16 (as the model's ``x.float()`` then ``.to(x.dtype)``)."""
    x, gamma, beta = _inputs((2, 16, 6, 6), cl, torch.bfloat16)
    y, mean, rstd = GN.group_norm_relu_fwd(x, gamma, beta, 8, 1e-5)
    y32, mean32, rstd32 = GN.group_norm_relu_fwd(x.float(), gamma, beta, 8,
                                                 1e-5)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, y32.to(torch.bfloat16))
    assert torch.equal(mean, mean32) and torch.equal(rstd, rstd32)


@pytest.mark.parametrize("shape,rows,blocks", [
    ((2, 64, 768, 768), 16, 256),       # a hospital's U-Net front
    ((10, 64, 768, 768), 80, 1280),     # the U-Net server's decoder
    ((80, 160, 56, 56), 640, 10240),    # DenseNet-121's middle
    ((80, 8, 7, 7), 640, 640),          # rows under 512: one warp each
])
def test_each_row_is_split_over_its_warps(shape, rows, blocks):
    """ATen's chains of a row are 16 warps (one block each on the card),
    or one warp of 32 chains under 512 elements; a chain's last step is
    ragged where the row is not a multiple of the stride."""
    n, c, h, w = shape
    length = c // 8 * h * w
    chains = R.chain_count(length)
    assert n * 8 == rows and rows * chains // R.WARP == blocks
    steps = -(-length // chains)
    last = length - (steps - 1) * chains    # chains with a last element
    assert 0 < last <= chains


def test_ragged_chains_cover_the_row():
    """Chains over a ragged row (2,200 elements: 152 chains of five, 360
    of four; warps of 160, 152 and 128) count every element once, and
    their warps' results, merged, are the row's moments."""
    x, _, _ = _inputs((1, 2, 1100, 1), False)
    parts = R.warp_partials_ref(x, 1)
    assert parts[0, :, 2].sum().item() == 2200
    assert sorted(set(parts[0, :, 2].tolist())) == [128.0, 152.0, 160.0]
    mean, rstd = R.merge_ref(parts, 1e-5)
    xr = x.double().reshape(-1)
    assert abs(mean.item() - xr.mean().item()) <= 1e-6
    assert abs(rstd.item() * (xr.var(unbiased=False) + 1e-5).sqrt().item()
               - 1) <= 1e-6


@pytest.mark.parametrize("cl", [False, True], ids=["nchw", "channels_last"])
def test_backward_against_aten_pair(cl):
    x, gamma, beta = _inputs((2, 16, 5, 6), cl)
    dy = torch.randn(2, 16, 5, 6, generator=torch.Generator().manual_seed(1))
    ins = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    (O.group_norm_relu(*ins, 8) * dy).sum().backward()
    ref = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    (F.relu(F.group_norm(ref[0], 8, ref[1], ref[2], 1e-5)) * dy
     ).sum().backward()
    for a, b in zip(ins, ref):
        assert torch.allclose(a.grad, b.grad, rtol=1e-5, atol=1e-5)


def test_backward_gets_no_gradient_for_the_statistics(monkeypatch):
    """mean and rstd, which the Function also returns, take no gradient:
    the backward gets None for them, not zeros of their shapes."""
    x, gamma, beta = _inputs((2, 16, 5, 6), True)
    seen = []
    backward = O._GroupNormReLU.backward
    monkeypatch.setattr(O._GroupNormReLU, "backward", staticmethod(
        lambda ctx, *g: seen.append(g) or backward(ctx, *g)))
    x.requires_grad_()
    O.group_norm_relu(x, gamma, beta, 8).sum().backward()
    assert len(seen) == 1 and seen[0][0].shape == x.shape
    assert seen[0][1:] == (None, None)


def test_backward_saves_the_callers_x():
    """The node keeps x as the caller passed it: the NCHW copy that the
    forward makes of a channels_last x is not held for the backward."""
    x, gamma, beta = _inputs((2, 16, 5, 6), True)
    x.requires_grad_()
    y = O.group_norm_relu(x, gamma, beta, 8)
    saved = y.grad_fn.next_functions[0][0].saved_tensors
    assert saved[0].data_ptr() == x.data_ptr()
    assert saved[0].is_contiguous(memory_format=torch.channels_last)


def test_relu_gradient_is_its_own_node():
    """ReLU's backward runs in a node of its own before GroupNorm's, as in
    ATen's pair, so the incoming gradient can go before GroupNorm's is
    made; the gradient reaching GroupNorm's node is the masked one."""
    x, gamma, beta = _inputs((2, 16, 5, 6), False)
    x.requires_grad_()
    y = O.group_norm_relu(x, gamma, beta, 8)
    node = y.grad_fn
    assert type(node).__name__ == "_ReLUGradBackward"
    inner = node.next_functions[0][0]
    assert type(inner).__name__ == "_GroupNormReLUBackward"
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    masked = torch.where(y > 0, dy, 0.0)
    (a,) = torch.autograd.grad(y, x, dy)
    (b,) = torch.autograd.grad(
        O._GroupNormReLU.apply(x, gamma, beta, 8, 1e-5)[0], x, masked)
    assert torch.equal(a, b)


def test_vmap_folds_into_the_batch(monkeypatch):
    """Per-example gradients through ``vmap(grad)`` (DP-SGD's path): one
    forward call for the whole batch, gradients those of a per-example
    loop (a row's chains do not depend on the other rows)."""
    x, gamma, beta = _inputs((4, 16, 5, 6), True)
    calls = []
    fwd = O.group_norm_relu_fwd
    monkeypatch.setattr(O, "group_norm_relu_fwd",
                        lambda *a: calls.append(a[0].shape) or fwd(*a))

    def loss(params, xi):
        return (O.group_norm_relu(xi, params[0], params[1], 8) ** 2).mean()

    xs = x.unsqueeze(1)                 # singleton sub-batches, as dpsgd
    per = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(
        (gamma, beta), xs)
    assert calls == [(4, 16, 5, 6)]
    for i in range(4):
        one = torch.func.grad(loss)((gamma, beta), xs[i])
        for a, b in zip(per, one):
            assert torch.allclose(a[i], b, rtol=1e-6, atol=1e-7)


def test_vmap_over_the_affine_params_is_refused():
    x, gamma, beta = _inputs((2, 16, 4, 4), False)
    with pytest.raises(NotImplementedError):
        torch.func.vmap(lambda g: O.group_norm_relu(x, g, beta, 8))(
            torch.stack([gamma, -gamma]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cl", [False, True], ids=["nchw", "channels_last"])
def test_layer_on_the_cpu_is_atens_pair(cl, dtype, monkeypatch):
    """On the CPU the model's layer runs ATen's ops, bit for bit the pair
    it replaced, and never the kernel's plain version."""
    monkeypatch.setattr(L, "group_norm_relu", None)
    x, _, _ = _inputs((2, 24, 6, 5), cl, dtype)
    p = {"scale": torch.randn(24), "bias": torch.randn(24)}
    pair = F.relu(F.group_norm(x.float(), L.num_groups(24), p["scale"],
                               p["bias"], 1e-5).to(x.dtype))
    assert torch.equal(L.groupnorm_relu_apply(p, x), pair)


# -- on the card -------------------------------------------------------------

# (N, C, H, W): the U-Net's 768^2 x 64 norms (a hospital's front, the
# server's decoder), DenseNet-121's middle (the first norm at 56^2 x 160,
# a bottleneck norm, 28^2, and 7^2 where planes are not whole vectors)
CARD_SHAPES = [(2, 64, 768, 768), (10, 64, 768, 768), (80, 160, 56, 56),
               (80, 128, 56, 56), (80, 256, 28, 28), (80, 1024, 7, 7)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import build
    build.build(["group_norm.cu"])
    return torch.device("cuda", 0)


def _card_inputs(shape, cl, dtype, dev):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    if cl:
        x = x.to(memory_format=torch.channels_last)
    gamma = torch.randn(shape[1], generator=g, device=dev)
    beta = torch.randn(shape[1], generator=g, device=dev)
    return x, gamma, beta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cl", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_kernel_is_atens_pair_on_card(shape, cl, dtype, card):
    x, gamma, beta = _card_inputs(shape, cl, dtype, card)
    before = (GN.STATS.launches, GN.APPLY.launches)
    y, mean, rstd = GN.group_norm_relu_fwd(x, gamma, beta, 8, 1e-5)
    assert (GN.STATS.launches, GN.APPLY.launches) == (before[0] + 1,
                                                      before[1] + 1)
    xf = x.float()
    pair = F.relu(F.group_norm(xf, 8, gamma, beta, 1e-5)).to(dtype)
    n, c, h, w = shape
    _, am, ar = torch.ops.aten.native_group_norm(xf.contiguous(), gamma,
                                                 beta, n, c, h * w, 8, 1e-5)
    torch.cuda.synchronize()
    assert y.is_contiguous() and y.dtype == dtype
    assert torch.equal(mean, am) and torch.equal(rstd, ar)
    assert torch.equal(y, pair)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 64, 768, 768), (3, 1240, 48, 47),
                                   (5, 3, 7, 9)], ids=str)
def test_to_nchw_is_contiguous_on_card(shape, dtype, card):
    """The channels_last copy (ragged tiles: 1,240 channels, 2,256
    positions) equals ``Tensor.contiguous``'s, one launch."""
    x, _, _ = _card_inputs(shape, True, dtype, card)
    before = GN.TO_NCHW.launches
    out = GN.to_nchw(x)
    assert GN.TO_NCHW.launches == before + 1
    assert out.is_contiguous() and torch.equal(out, x.contiguous())
    assert GN.to_nchw(out) is out


@pytest.mark.parametrize("shape", [(2, 64, 96, 96), (4, 8, 7, 7)], ids=str)
def test_kernel_against_plain_on_card(shape, card):
    """The plain version on the card (its FMAs taken in float64) within an
    ulp of the kernel."""
    x, gamma, beta = _card_inputs(shape, False, torch.float32, card)
    y, mean, rstd = GN.group_norm_relu_fwd(x, gamma, beta, 8, 1e-5)
    py, pm, pr = R.group_norm_relu_ref(x, gamma, beta, 8, 1e-5)
    ulp = 2.0 ** -23
    assert ((mean - pm).abs() <= ulp * pm.abs()).all()
    assert ((rstd - pr).abs() <= ulp * pr).all()
    assert ((y - py).abs() <= 4 * ulp * py.abs() + 1e-7).all()


@pytest.mark.parametrize("cl", [False, True], ids=["nchw", "channels_last"])
def test_kernel_captures_and_replays_bit_equal(cl, card):
    x, gamma, beta = _card_inputs((2, 64, 768, 768), cl, torch.float32, card)
    eager = GN.group_norm_relu_fwd(x, gamma, beta, 8, 1e-5)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        GN.group_norm_relu_fwd(x, gamma, beta, 8, 1e-5)    # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = GN.group_norm_relu_fwd(x, gamma, beta, 8, 1e-5)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([t.clone() for t in out])
    for a, b, e in zip(*replays, eager):
        assert torch.equal(a, b) and torch.equal(a, e)
