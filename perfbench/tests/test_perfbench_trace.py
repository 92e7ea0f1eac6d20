"""The reduction of a device trace (busy time as the union of kernel
intervals, idle gaps named by the spans around them, device time by
class) and the per-layer readers, on a synthetic record."""

import pytest

from perfbench import harness, trace

CLASSES = trace.kernel_classes()
# (name, start us, end us): two overlapping kernels of a graph, a gap
# inside "pack" (itself inside "run_epoch"), one inside "run_epoch" alone,
# one outside every span
KERNELS = [("sm80_xmma_fprop_implicit_gemm_f32f32", 0.0, 100.0),
           ("void sqnorm_partials(long long const*, int)", 160.0, 180.0),
           ("void scale_accum_kernel<4>(long long const*)", 180.0, 200.0),
           ("void roundtrip_vec_kernel<float, 4>", 50.0, 150.0),
           ("void noise_roundtrip_vec_kernel<float>", 150.0, 160.0),
           ("void at::native::RowwiseMomentsCUDAKernel<float>", 300.0, 400.0),
           ("Memcpy HtoD (Pageable -> Device)", 400.0, 420.0),
           ("void at::native::vectorized_elementwise_kernel", 700.0, 800.0)]
SPANS = [("run_epoch", 0.0, 600.0), ("pack", 160.0, 300.0)]


def test_busy_is_the_union():
    assert trace.busy_intervals(KERNELS) == [[0.0, 200.0], [300.0, 420.0],
                                             [700.0, 800.0]]
    assert trace.busy_us(KERNELS) == 420.0


def test_idle_gaps_are_named_by_the_innermost_span():
    gaps = trace.idle_gaps(KERNELS, SPANS, 0.0, 1000.0)
    assert gaps == [("run_epoch", 280e-6), ("between", 200e-6),
                    ("pack", 100e-6)]


@pytest.mark.parametrize("name, cls", [
    ("void roundtrip_vec_kernel<float, 4>", "hand"),
    ("void quantize_general_kernel<float>", "hand"),
    ("sqnorm_rows_kernel", "hand"),
    ("sm80_xmma_wgrad_implicit_gemm_indexed", "conv"),
    ("void wgrad_alg0_engine<float, 128>", "conv"),
    ("void at::native::(anonymous namespace)::conv_depthwise2d_forward_kernel",
     "conv"),
    ("void at::native::RowwiseMomentsCUDAKernel<float>", "group_norm"),
    ("CatArrayBatchedCopy<float>", "cat_copy"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy"),
    ("void at::native::vectorized_elementwise_kernel", "other")])
def test_classes(name, cls):
    assert trace.class_of(name, CLASSES) == cls


def test_device_ops_sum_launches():
    ops = trace.device_ops(KERNELS + [KERNELS[0]], top=2)
    assert ops[0] == ("sm80_xmma_fprop_implicit_gemm_f32f32", 200e-6)


def record():
    return {"kernels": KERNELS, "spans": SPANS, "classes": CLASSES,
            "wall_s": 1e-3, "busy_s": 420e-6, "epochs": 1, "steps": 2,
            "samples": 160, "dispatches": 3,
            "program_spans": {"pack": [0.05]},
            "flops_per_sample": 1e6, "peak_flops_per_s": 67e12,
            "hbm_bytes_per_s": 3.35e12, "k3_bytes_per_step": 1.0e5}


@pytest.mark.parametrize("name, value", [
    ("pack_ms_per_epoch", 50.0),
    ("replays_per_step", 1.5),
    ("conv_ms_per_step", 0.05),
    # group norm 100 us + other 100 us over 2 steps; K3, K4, copies out
    ("cnn_other_ms_per_step", 0.1),
    # 2 steps x 1e5 bytes at 3.35e12 B/s over K3's 100 us (not K4's)
    ("k3_roofline", 100 * 2e5 / 3.35e12 / 100e-6),
    ("device_idle_share", 58.0),
    ("step_mfu", 100 * 3 * 1e6 * 160 / 1e-3 / 67e12)])
def test_readers(name, value):
    got = harness.module("metrics", name).read(record())
    assert got == pytest.approx(value)


@pytest.mark.parametrize("name", ["conv_ms_per_step", "k3_roofline",
                                  "device_idle_share", "step_mfu"])
def test_readers_find_nothing_without_device_events(name):
    rec = dict(record(), kernels=[], busy_s=0.0)
    assert harness.module("metrics", name).read(rec) is None
