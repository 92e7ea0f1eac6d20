"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--steps N] [--profile]

Phases, in order; any failure exits nonzero before the last line:
  1. print the card's name and power limit (``nvidia-smi``);
  2. build the kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
     per source, all started together);
  3. hold K1 (quantize), K2 (dequantize), K3 (fused roundtrip) and K4
     (fused roundtrip + cut noise, masked and unmasked) bit for bit against
     their plain PyTorch versions on the card, in f32 and bf16, at the main
     path's shape (250,880 x 160) and a ragged one (7 x 96), check K3 ==
     K2(K1(x)) and K4 == K3 + the masked add; K1-K4 also on each path of
     their row groups (the vector path at every width the main path hands
     them, D = 160, 64, 128, 256, 512, 576, 728, 768, K2 also 1024, the
     general path at D = 1, 3, 33, 161 and on a misaligned view: K1, K3
     and K4's x, K2's q one byte past an allocation, K4 also a misaligned
     z), on rows with every third row zero and on rows of exact .5 ties,
     K2 on levels of +-127 under scales from MIN_AMAX * INV_127 to 2^20
     and against ``torch.mul(q, s, out=out)``, K4 under row weights of
     ones, 0/1 and fractions, and K1-K4 past 2^31 elements (33,554,440 x
     64 bf16: row offsets that only 64-bit arithmetic forms); hold K5
     (per-example squared norms) and K6 (scaled batch sum) within 1e-6
     relative of the same sums taken in double, over one hospital's real
     364-leaf per-example gradient table (16 x 6,948,609 f32) and a ragged
     small one; hold K7 (flash attention: f32 on CUDA cores, bf16 on
     tensor cores) within the reference's bars (2e-6 f32, 2e-2 bf16) at
     its test shapes, a ragged GQA case in both types and head_dim-128
     cases in bf16, and at the scoring shape (4 x 9/3 heads x 2048 x 64,
     causal: 1e-5 f32, 2e-2 bf16), and K8 (SSD chunk: C B^T on bf16 tensor
     cores) within 3e-4 at small, grouped and ragged shapes (unaligned B/C
     rows too) and at the scoring shape (4 x 16 chunks x 128 x 24 heads x
     64, state 128) under two dt ranges; time each with CUDA events beside
     its bound and, for K2 and K5-K7, one PyTorch call (K2: ``torch.mul``,
     K7: SDPA); K1-K4 are timed at the main path's shape and the U-Net's
     widest leaf (5,898,240 x 64) in both dtypes, as bare launches
     (outputs allocated once) beside their wrappers, K4 also at one
     hospital's 50,176 x 160 f32 rows; hold K9 (GroupNorm + ReLU) bit for
     bit to ATen's ``F.relu(F.group_norm(...))`` at the U-Net's 768^2 x 64
     norms (a hospital's front at batch 2, its first norm channels_last,
     the server's decoder at batch 10) and DenseNet-121's middle at batch
     80 (56^2 x 160 channels_last, 56^2 x 128, 28^2 x 256, 7^2 x 1024),
     f32 and bf16, and within an ulp to its plain version at the front;
     time it in f32 at each beside its byte bound and ATen's pair (its
     launches on the main paths are held in phases 5, 6 and 9);
  4. train SplitFedv3 (``sflv3_ac``) on DenseNet-121-mini at 32^2 on the
     card and on the CPU from the same start, and hold the card's losses
     and scores against the CPU's plain path over an identity link (the
     int8 link's difference is printed); then the same privately (DP-SGD
     with noise 0 and C = 1: deterministic), losses within 1e-4; then 2
     steps of centralized, FL, SL-AC/AM, SFLv2 and SFLv1 (LS and NLS) on
     DenseNet-mini and of SL-AM and SFLv3 (LS and NLS) on the U-Net-mini
     under the same bars; and run SmolLM's and Mamba2's SMOKE configs in
     f32 on the card and the CPU (scoring logits, loss, greedy tokens),
     then the greedy tokens of the Zamba2, Kimi-K2 (MoE) and InternVL2
     (frontend) SMOKEs: the card's from the captured decode step (one
     capture, 7 replays), each equal to the CPU's eager tokens;
  5. the main path: SplitFedv3 on DenseNet-121 at 224^2, 5 synthetic
     hospitals, batch 16 per hospital, over ``Transport("int8")`` fused
     (K3) and unfused (K1, K2), then ``val_loss`` and
     ``evaluate``; the first step's losses of the two runs must be
     bit-identical, every launch count of the path nonzero, and every step
     must launch K9's two kernels once per GroupNorm of its forwards (5
     fronts, the server's middle);
  6. the private main path: the same with ``PrivacyConfig(noise_multiplier
     =1.0, clip_norm=1.0, cut_noise_std=0.5)`` over the int8 link fused
     (K4, K5, K6) and unfused (K1, K2 + the masked add, K5, K6), first-step
     losses bit-identical, every launch count nonzero, K9's two kernels
     as often as each other in every step, then
     ``privacy_report``, ``val_loss`` and ``evaluate``; and a cut-noise-only
     run (DP off) with one K4 launch per step over all hospitals' rows;
  7. LM serving at published width, random weights, bf16: SmolLM-135M and
     Mamba2-130M score 4 prompts of 2048 tokens with ``apply`` and
     ``loss`` (use_pallas: K7 30 or K8 24 launches per forward), then over
     the int8 cut link at layer 4 (K3 once more), each against the same
     call with use_pallas=False; then 32 greedy tokens after 4 prompts
     of 256 over the caches (no kernel) through the captured decode step
     (``captured_decode_step``: one CUDA graph a model, replayed) and
     through the eager ``make_decode_step`` loop from the same prompt
     pass: tokens equal, each step's logits bit-equal (else within
     ``LOGIT_BARS``, the largest difference printed), one program with
     one capture, new tokens per second both ways (``greedy_generate``
     against the eager loop, the prefill included); the same for
     Zamba2-7B at published width with its depth cut 81 -> 12
     (``hybrid_attn_every`` 6 kept: the shared block applied twice, on
     two caches);
  8. the paper's Table-2 grid at full width: every method on DenseNet-121
     at 224^2 (5 hospitals x 2 batches of 16; LS, and NLS for SL-AM,
     SFLv2 and SFLv3), then SFLv3 and SL-AM on the paper's U-Net at 768^2
     (5 hospitals x 2 batches of 2; LS and NLS), the split family over the
     fused int8 link: per run the step seconds, step-1 losses, K1-K3
     launches (K3 exactly once per boundary leaf, crossing and step), K3's
     output at every leaf of the first step bit-equal to its plain
     version on the same rows and taken on its vector path, the
     transport's bytes (exactly ``comm_per_epoch``'s train legs), the
     client sync (SFLv2/v1 one tree, SL/SFLv3 distinct) and ``evaluate``;
  9. the compiled engine (``core/strategies/engine.py``: one captured CUDA
     graph per program, replayed) against the stepwise engine from the
     same start, under cuDNN's deterministic algorithms: every DenseNet
     run of phase 8 in f32 and in bf16, the private SFLv3 step (f32),
     SFLv3 over the unfused int8 link (bf16: K1, K2 on bf16 rows, each
     K2 captured on its vector path),
     3-epoch ``Strategy.run``s of SFLv3 and FL, the U-Net runs of phase
     8 in bf16 and its SFLv3 runs in f32; per run every loss, param and
     epsilon equal to the stepwise engine's, one capture per program
     body, the launches per replay (K3 once per boundary leaf; K4-K6
     once per hospital on the private step; K9's two kernels alike, and
     on SFLv3's non-private runs once per GroupNorm of the step's forwards,
     5 fronts and tails and the middle), K3's output at every
     boundary leaf of the last replay bit-equal to its plain version on
     the graph's own buffers, the wire bytes equal to ``comm_per_epoch``'s
     train legs, ``evaluate``, and both engines' step seconds and peaks;
     one profiled replay of SFLv3's f32 LS step of each model runs K9 and
     no forward kernel of ATen's GroupNorm;
 11. the private grid at full width (it runs before phase 10, which
     prints the line): DenseNet-121 at 224^2, 5 hospitals of 40 images at
     batch 16 (two full batches and a kept remainder of 8; SFLv3 drops
     it) over the fused int8 link, on both engines from the same start
     under cuDNN's deterministic algorithms: DP-SGD (sigma 1.1, C = 1) on
     centralized and FL, DP-SGD + cut noise (std 0.5) on SL-AC, SL-AM and
     SFLv2 (LS) and on SL-AC and SFLv3 (NLS), cut noise alone on SL-AM,
     and FL with DP and secure aggregation; per row the losses before the
     first padded step (SFLv3: every loss and param) equal, the padded
     runs within ``PADDED_BAR``, epsilon per hospital equal, K4/K5/K6
     launches per stepwise step and per replay (K4 once per leaf and
     crossing, K5/K6 once per clip), K4 captured with the remainder
     step's 0/1 row weights, step and replay seconds and peaks, and
     ``evaluate``;
 12. participation and the aggregation rules at full width (it also runs
     before phase 10), DenseNet-121 at 224^2, batch 16, the fused int8
     link, the compiled engine, cuDNN's deterministic algorithms: (a) FL,
     SL-AC, SFLv2-AC and SFLv3-AC on the main path's 5 hospitals (2
     batches each), 2 rounds, under ``Participation(n_global=5, k=5)``
     against ``participation=None`` from the same start: losses, params
     and wire bytes equal bit for bit; (b) 10 hospitals of 32 images,
     ``Participation(n_global=10, k=4, seed=0)``, 2 rounds: FL with
     DP-SGD (sigma 1.1, C 1), SL-AM and SFLv3-AC with DP-SGD and cut
     noise (std 0.5), SFLv2-AC with cut noise alone; per row one capture
     per program body, the launches per replay (K4 once per crossing,
     SFLv3 once per slot under DP; K5/K6 once per clip), the hospitals
     outside a round untouched by it (SFLv2: every hospital holds the
     sampled mean), epsilon per hospital the accountant's at q K/N and
     below k=N's, the wire bytes the sampled hospitals' train legs and
     the client sets the sampled ids, ``evaluate``, and the replay
     seconds and peak beside the same program without participation on
     4 hospitals; (c) FL over the 10 hospitals, k=5, 3 rounds, under
     ``TrimmedMean(0.2)``, ``CoordinateMedian()``,
     ``StalenessDiscounted(0.5)`` and ``Hierarchical`` over 3 regions,
     and ``CoordinateMedian()`` again at k=4 (an even count: the mean of
     the two middle values): the captured round replayed once more on
     the program's own stacked locals within 1e-6 (of the rows' scale)
     of the rule in float64 on the host, and the round body's time a
     replay;
 13. after training, at full width (it also runs before phase 10):
     DenseNet-121 at 224^2, the main path's 5 hospitals, batch 16, the
     fused int8 link, cuDNN's deterministic algorithms: (a) SFLv3-AC and
     SL-AM, 2 epochs of 2 batches a hospital on both engines from the same
     start under ``adam(cosine_warmup(1e-4, 2, 6), weight_decay=1e-4)``:
     losses and params equal, the rate each step read (written on the
     device by the schedule) the schedule's and not all one, replay
     seconds; (b) ``timeline_from_accounting`` of each trained transport
     over ``hospital_wan`` equal across the engines, its first epoch equal
     to ``simulate``, and wire_sweep's two gates at its hospital sizes
     (identity bytes within 1% of ``comm_per_epoch`` for every method; an
     accounting-fed timeline equal to ``simulate``), each method's int8
     epoch seconds over ``lan``, ``hospital_wan`` and ``cellular`` and
     its straggler sensitivity; (c) ``boundary_error`` of
     ``Transport("int8")`` on the trained SFLv3 hospital 0 and 16 images:
     K1 and K2 launch, every value equal to the plain versions'; (d)
     ``export`` through ``save_servable``/``load_servable`` and the whole
     state through ``checkpoint``, bit-equal, the export's scores equal to
     ``Strategy.scores``; (e) ``BucketScorer`` in f32 and bf16: one capture
     per bucket of (1, 2, 4, ..., 64), none while scoring 1, 3, 16, 17, 64
     and 100 images, scores within 1e-5 (bf16 0.05) of ``Strategy.scores``'
     function, each bucket's replay ms (CUDA events) and images per
     second; (f) ``ScreeningService``: 256 single-image requests from 8
     threads with one swap in the middle, every score within 1e-5 of
     exactly one version's and the versions never going back, p50/p99
     latency, mean batch and requests per second, and ``Backpressure``
     past ``max_queue``;
 14. the observed grid (it also runs before phase 10): ``observe=`` at
     full width, DenseNet-121 at 224^2, the main path's 5 hospitals (2
     batches of 16 each), the fused int8 link, the compiled engine,
     cuDNN's deterministic algorithms: (a) centralized, FL, SL-AM,
     SFLv2-AC, SFLv3-AC and SFLv1-AC, 2 epochs, each ``run()`` then
     ``run(observe=Telemetry())`` from the same start on the same
     strategy: params bit-equal, the same replays per body and hand-kernel
     launches per replay (K3 once per boundary leaf), one capture per
     observed body, the family's taps on rows of 5 hospitals (centralized
     1), all finite, the update cosine in [-1, 1], the last replay's cut
     statistics the moments of the payload K3 shipped (its output held on
     the graph's buffers), the stepwise engine's taps within 1e-4, and
     each method's replay seconds with and without the taps; (b) FL with
     DP-SGD (sigma 1.1, C 1) and SFLv3-AC with DP-SGD and cut noise (std
     0.5): the same, the clip fraction in [0, 1] and equal across the
     engines, the cut statistics on K4's output, K4/K5/K6 per replay as
     unobserved, the epsilon series' last row ``privacy_report()``'s; (c)
     FL under ``Participation(n_global=10, k=4, seed=0)``, 2 rounds: each
     round's ``participation`` the sampled ids, unsampled columns NaN, and
     the split family's ``ValueError``; (d) SFLv3-AC LS on the U-Net at
     768^2 in bf16, 5 x 2 batches of 2, ``run()`` then ``run(observe=
     True)`` on one strategy (one memory pool): params bit-equal, the cut
     statistics over the 5-leaf boundary, both peaks; (e) on the observed
     SFLv3 run: its tracer's spans (``h2d`` an epoch, one ``replay.<body>``
     a replay that did not capture), ``round_events`` and the simulated
     wire lane written as one Chrome trace and read back, ``write_runlog``
     / ``write_report``, ``torch_profile`` around one observed replay (its
     trace names K3's kernel), ``graph_cost`` and ``cost_summary``; then
     three observed epochs under ``torch.profiler``: each ``replay.step``
     span of the tracer's device lane, mapped onto the profiler's clock,
     starts within ``ALIGN_MEDIAN_MS`` (median) and ``ALIGN_WORST_MS``
     (worst) of its first kernel, and the kernels are busy for
     ``ALIGN_BUSY`` or more of the spans' summed length;
 15. LM training and the model kinds (it also runs before phase 10): K1,
     K2 and K3 bit-equal to their plain versions on their design's paths
     (vector at 576, general at 5,120) and timed at the LM links' bf16 rows, 16,384 x 576 and 4,096 x 5,120
     (``lm_576_bf16``, ``lm_5120_bf16`` in the kernels line); then, the
     counts at 0: ``chain(clip_by_global_norm, add_noise, adam)`` on the
     compiled engine against the stepwise one, FL and SFLv3-AC on
     DenseNet-121 at 224^2, 2 epochs, every loss and param bit-equal; (a)
     SmolLM-135M SplitFedv3 at published widths and depth (remat, bf16
     compute, f32 masters), 4 hospitals x 2 sequences of 2048 + 1 tokens,
     30 steps of ``make_sflv3_train_step(compress=True)`` under
     ``adam(wsd)``: the first loss in [10.3, 12.3], the mean of the last 5
     below the first 5's, K1 and K2 once a step, step 1 against the plain
     link from the same state (losses within 1e-2, params within two of
     step 1's rates), step ms (CUDA events), tokens/s, peak memory; then 5
     steps of ``make_plain_train_step``; (b) Llama-4 Scout 17B-16E at
     published widths, 2 layers cut after the first (one MoE layer a
     segment), bf16, 2 sequences of 2048 + 1: the scoring forward over
     K3 against the plain link (``LOGIT_BARS``), ``loss`` with the aux
     (> 0, ``dropped`` in [0, 1]), ``loss.backward()`` over K1/K2 with
     every gradient finite, tokens/s and peak; (c) every registry SMOKE
     config in f32, card against CPU: logits, loss and the params after
     one Adam step; every full CONFIG through ``param_shapes`` (meta, no
     card memory) with its param count;
 16. placement over several devices (it also runs before phase 10),
     DenseNet-121 at 224^2, 5 hospitals of 32, 16, 32, 16 and 32 images,
     2 epochs on the compiled engine, cuDNN's deterministic algorithms:
     (a) ``shard=True`` on one card
     against ``shard=False`` on FL and SFLv3-AC (fused int8), params,
     losses, scores and wire bytes bit-equal; (b) ``shard=True`` over four
     virtual devices (the card four times: 8 hospitals, 3 phantoms)
     against ``shard=False`` from the same start, for FL with DP-SGD (K5,
     K6), SL-AM, SFLv2-AC, SFLv3-AC with cut noise (K4), SFLv1-AC and an
     observed SFLv3-AC (K3): params, losses, scores and telemetry within
     1e-5 (the bit-equal rows said so), epsilon and wire bytes equal,
     every chunk program on its device and captured once per body, the
     second run's device milliseconds (CUDA events) and wall beside the
     unplaced run's, the peaks; (c) the same over the distinct cards when
     the machine has several (a line says when it has not); (d) beside
     them, in a process of its own, the dry run (``launch.dryrun``) of
     SmolLM-135M's and Llama-4 Scout's ``train_4k`` at full width on the
     single production mesh (a fake process group of 256): per-device
     FLOPs, HBM bytes, collectives by kind, param, optimizer and live
     bytes, the H100 roofline terms, and nothing allocated (the card's
     allocated bytes unchanged, no op result holding memory);
 17. the port's six reference examples (``examples/<name>_torch.py``:
     quickstart, federated_cxr, compressed_splitfed, private_splitfed,
     train_and_serve, serve_decode) through their ``main`` on the card at
     the reference's own sizes (it also runs before phase 10): their
     printed results, every loss finite and the non-private ones falling,
     train_and_serve's own assertions, serve_decode's tokens well formed
     and each model's decode step captured once;
 10. print one JSON line ``{"kernels": [...]}`` (K1-K9; K1-K4 with their
     bf16 rows, ``unet_leaf`` entries and ``bare_ms``, K4 with
     ``one_hospital``, K1-K3 with their LM link rows, K9 with its other
     ``shapes``; launches of every phase, K9's both kernels'),
     then the last line ``{"ok": true, "device": {...}}``.

Each phase prints its wall time.  ``--profile`` adds one profiled fused
step of each main path, of the U-Net's SFLv3 and SL-AM (LS) in phase 8,
one replayed step of the private SFLv3 and of SL-AM (f32) in phase 9,
of the private centralized and SL-AC (LS) rows in phase 11, one
profiled scoring forward of each LM and one SmolLM-135M SFLv3 training
step in phase 15 (``torch.profiler``), and
prints the device time by kernel and the busy share (the union of the
kernels' intervals over the wall time).  The script imports nothing of
JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12              # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12            # bf16 tensor cores, dense
MAIN_ROWS, MAIN_D = 80 * 56 * 56, 160   # the cut tensor of 5 x 16 images
# the U-Net's widest boundary leaf in phase 8: the 768^2 x 64 skip of 5
# hospitals x 2 images
UNET_SIZE, UNET_BATCH = 768, 2
UNET_ROWS, UNET_D = 5 * UNET_BATCH * UNET_SIZE ** 2, 64
# K1, K3 and K4 past 2^31 elements (bf16, 4.3 GB): row * D overflows 32
# bits
WIDE_ROWS = 2 ** 31 // UNET_D + 8
# the row kernels' (K1, K3, K4) checked widths: their vector path at every
# width the main path hands them (DenseNet's cut, the U-Net's leaves, the
# SmolLM and Mamba2 links of phase 7), their general path at ragged widths
VECTOR_D = (160, 64, 128, 256, 512, 576, 728, 768)
GENERAL_D = (1, 3, 33, 161)
# K4's launch on the private step: one hospital's 16 x 56 x 56 cut rows
HOSPITAL_ROWS = 16 * 56 * 56
# operations per element of each kernel: K1 abs, max, divide, round, clamp;
# K2 convert, multiply; K3 both; K4 K3's and the noise multiply and add;
# K5 multiply, add; K6 multiply, add
OPS_PER_ELEM = {"K1": 5, "K2": 2, "K3": 7, "K4": 9, "K5": 2, "K6": 2}
BATCH = 16                       # images per hospital and step at 224^2
PRIVACY = dict(noise_multiplier=1.0, clip_norm=1.0, cut_noise_std=0.5,
               seed=0)           # examples/private_splitfed.py's defaults
CUDA_SRC = "src/repro_torch/kernels/csrc/"
# the LM scoring path (phase 7): 4 prompts of 2048 tokens
LM_BATCH, LM_SEQ = 4, 2048
LM_ATTN = (LM_BATCH, 9, 3, LM_SEQ, 64)      # SmolLM-135M: B, H, KV, S, D
LM_SSD = (LM_BATCH, LM_SEQ // 128, 128, 24, 64, 1, 128)  # Mamba2-130M:
                                            # b, nc, q, h, p, g, n
GEN_PROMPT, GEN_NEW = 256, 32               # greedy_generate, 4 prompts
# Zamba2-7B's generation in phase 7: published width, 81 layers cut to 12
# (hybrid_attn_every 6 kept: the shared block applied twice, two caches)
ZAMBA_DEPTH = 12
# the decode step's other kinds held card against CPU in phase 4
GEN_SMALL = ("zamba2-7b", "kimi-k2-1t-a32b", "internvl2-76b")
# K7 in bf16 at LM_ATTN: the largest ||out - ref|| / ||ref|| over rows
K7_ROW_REL = 2e-2


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def roof(nbytes: int, ops):
    """(bound_ms, bound_by): the larger of the bytes the function must
    move over HBM bandwidth and its operations, ``[(count, peak per s),
    ...]``, each over the card's peak rate for its operands' type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / peak for n, peak in ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(name: str, rows: int, d: int, in_bytes: int, out_bytes: int):
    """The row kernels K1-K6: a few f32 operations per element."""
    return roof(in_bytes + out_bytes,
                [(OPS_PER_ELEM[name] * rows * d, F32_OPS_PER_S)])


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev):
    import torch
    from repro_torch.kernels.act_compress import act_compress as AC
    from repro_torch.kernels.act_compress import ref as R
    from repro_torch.kernels.cut_fuse import cut_fuse as CF
    from repro_torch.kernels.cut_fuse import ref as RF

    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    for shape in [(MAIN_ROWS, MAIN_D), (7, 96)]:
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, device=dev, generator=gen) * 3).to(dt)
            z = torch.randn(shape, device=dev, generator=gen) * 0.5
            q, s = AC.quantize_rows(x)
            q_r, s_r = R.quantize_ref(x)
            out = AC.dequantize_rows(q_r, s_r, dt)
            out_r = R.dequantize_ref(q_r, s_r, dt)
            rt = CF.roundtrip_rows(x)
            rt_r = R.roundtrip_ref(x)
            torch.cuda.synchronize()
            k1 = torch.equal(q, q_r) and torch.equal(s, s_r)
            k2 = torch.equal(out, out_r)
            k3 = torch.equal(rt, rt_r)
            composed = torch.equal(rt, AC.dequantize_rows(q, s, dt))
            err["K1"] = max(err["K1"], max_err(q, q_r), max_err(s, s_r))
            err["K2"] = max(err["K2"], max_err(out, out_r))
            err["K3"] = max(err["K3"], max_err(rt, rt_r))
            k4 = []
            for masked in (False, True):
                w = torch.ones((shape[0], 1), device=dev)
                if masked:
                    w = (torch.rand((shape[0], 1), device=dev, generator=gen)
                         < 0.6).float()
                nz = CF.noise_roundtrip_rows(x, z, w)
                nz_r = RF.noise_roundtrip_ref(x, z, w)
                torch.cuda.synchronize()
                err["K4"] = max(err["K4"], max_err(nz, nz_r))
                k4.append(torch.equal(nz, nz_r)
                          and torch.equal(nz, rt + (z * w).to(dt)))
            log(f"  {tuple(shape)} {str(dt)[6:]}: K1 {k1}  K2 {k2}  K3 {k3}"
                f"  K3==K2(K1) {composed}  K4==plain==K3+add unmasked "
                f"{k4[0]} masked {k4[1]}")
            if not (k1 and k2 and k3 and composed and all(k4)):
                fail(f"kernel disagrees with its plain version at {shape} "
                     f"{dt}")

    table = {"K1": check_k1(dev, gen, err["K1"]),
             "K2": check_k2(dev, gen, err["K2"])}
    check_k3_k4(dev, gen)
    table.update(time_k3_k4(dev, gen, err))
    check_past_2_31(dev, gen)
    table.update(check_dp_clip(dev, gen))
    table.update(check_group_norm(dev, gen))
    return table


def row_path(plan) -> str:
    """A row kernel's path from its plan (``act_compress.vector_plan``)."""
    return "general" if plan is None else "vector (group %d, vecs %d)" % plan


def k1_path(x) -> str:
    """The path K1 takes for the rows ``x`` into a fresh (aligned) q."""
    from repro_torch.kernels.act_compress import act_compress as AC

    return row_path(AC.quantize_plan(x.shape[1], x.dtype, x.data_ptr(), 0))


def k2_path(q, dtype) -> str:
    """The path K2 takes for the int8 rows ``q`` into a fresh (aligned) out
    of ``dtype``."""
    from repro_torch.kernels.act_compress import act_compress as AC

    return row_path(AC.dequantize_plan(q.shape[1], dtype, q.data_ptr(), 0))


def k3_path(x) -> str:
    """The path K3 takes for the rows of ``x`` (along its last axis; the
    wrapper copies a view that is not contiguous) into a fresh out."""
    from repro_torch.kernels.cut_fuse import cut_fuse as CF

    ptr = x.data_ptr() if x.is_contiguous() else 0
    return row_path(CF.roundtrip_plan(x.shape[-1], x.dtype, ptr, 0))


def k4_path(x, z) -> str:
    """The path K4 takes for the rows ``x`` and noise ``z`` into a fresh
    out."""
    from repro_torch.kernels.cut_fuse import cut_fuse as CF

    return row_path(CF.noise_roundtrip_plan(x.shape[1], x.dtype, x.data_ptr(),
                                            z.data_ptr(), 0))


def k1_equals_plain(x, q, s) -> bool:
    """K1's ``q`` and ``s`` of the rows ``x`` bit-equal to the plain
    version's, taken over 2^26 elements of rows at a time (the quantize is
    row-wise, so the cut is exact)."""
    import torch
    from repro_torch.kernels.act_compress import ref as R

    step = max(1, 2 ** 26 // x.shape[1])
    for i in range(0, len(x), step):
        q_r, s_r = R.quantize_ref(x[i:i + step])
        if not (torch.equal(q[i:i + step], q_r)
                and torch.equal(s[i:i + step], s_r)):
            return False
    return True


def rows_vs_plain(out, plain, *ins):
    """A row kernel's ``out`` (T, D) against ``plain(*ins)``, taken over
    2^26 elements of rows at a time (the kernels are row-wise, so the cut
    is exact): (bit-equal, max abs error)."""
    import torch

    step = max(1, 2 ** 26 // out.shape[1])
    same, err = True, 0.0
    for i in range(0, len(out), step):
        ref = plain(*(a[i:i + step] for a in ins))
        same = same and torch.equal(out[i:i + step], ref)
        err = max(err, max_err(out[i:i + step], ref))
    return same, err


def tie_rows(dev, gen, rows, d, dt):
    """Rows whose every x / scale is an exact .5 tie but one: each row
    holds one +-127 * 2^e (so that its scale is exactly 2^e, with e from -4
    to 4) and otherwise (k + 0.5) * 2^e for k drawn in [-127, 126], all
    exact in f32 and in bf16 (at most 8 significant bits)."""
    import torch

    k = torch.randint(-127, 127, (rows, d), device=dev, generator=gen)
    v = k.float() + 0.5
    v[:, 0] = torch.where(torch.rand(rows, device=dev, generator=gen) < 0.5,
                          -127.0, 127.0)
    e = (torch.arange(rows, device=dev) % 9 - 4).float()
    return (v * torch.exp2(e)[:, None]).to(dt)


def tie_share(x, s) -> float:
    """The share of the elements of ``x`` whose x / scale is a .5 tie."""
    r = x.float() / s
    return float(((r - r.floor()) == 0.5).float().mean())


def misaligned(dev, dt, rows, d):
    """A contiguous (rows, d) view one element past an allocation's
    start."""
    import torch

    return torch.empty(rows * d + 1, device=dev, dtype=dt)[1:].view(rows, d)


ROW_CASE_ROWS = 4099     # a multiple of no block's rows


def row_cases(dev, gen, dt):
    """The rows phase 3 holds K1, K3 and K4 to their plain versions on:
    (label, x, want), want the path ("vector", "general" or None for
    either) at every width of VECTOR_D and GENERAL_D, on a misaligned
    view, and on rows with every third row zero or of .5 ties."""
    import torch

    rows, cases = ROW_CASE_ROWS, []
    for d in VECTOR_D + GENERAL_D:
        x = (torch.randn((rows, d), device=dev, generator=gen) * 3).to(dt)
        cases.append((f"D {d}", x, "vector" if d in VECTOR_D else "general"))
    x = misaligned(dev, dt, rows, 160)
    x.copy_(torch.randn((rows, 160), device=dev, generator=gen) * 3)
    cases.append(("D 160, misaligned view", x, "general"))
    for d in (160, 728, 161):
        x = (torch.randn((rows, d), device=dev, generator=gen) * 3).to(dt)
        x[::3] = 0
        cases.append((f"D {d}, every third row zero", x, None))
        cases.append((f"D {d}, .5 ties", tie_rows(dev, gen, rows, d, dt),
                      None))
    return cases


def check_k1(dev, gen, err):
    """K1 bit-equal to its plain version on every path of its design, then
    timed at the main path's shape and at the U-Net's widest leaf, in f32
    and bf16, as wrapper calls and as bare launches (outputs allocated once,
    QUANTIZE alone); returns K1's row of the kernels line."""
    import torch
    from repro_torch.kernels.act_compress import act_compress as AC
    from repro_torch.kernels.act_compress import ref as R

    zero_scale = (torch.tensor(R.MIN_AMAX, dtype=torch.float32)
                  * R.INV_127).item()
    for dt in (torch.float32, torch.bfloat16):
        for label, x, want in row_cases(dev, gen, dt):
            path = k1_path(x)
            q, s = AC.quantize_rows(x)
            ok = k1_equals_plain(x, q, s)
            torch.cuda.synchronize()
            if "zero" in label:
                ok = ok and bool((s[::3] == zero_scale).all()) and not bool(
                    q[::3].any())
            if "ties" in label:
                # the case is what it says: nearly every x / scale is a tie
                ties = tie_share(x, s)
                ok = ok and ties > 0.9
                label += f" ({100 * ties:.1f}% ties)"
            log(f"  K1 {str(x.dtype)[6:]} {label}, {path}: {ok}")
            if not ok or (want and not path.startswith(want)):
                fail(f"K1 at {label} {x.dtype}: bit-equal {ok}, path {path} "
                     f"(want {want})")

    row = None
    for label, t, d in [("main", MAIN_ROWS, MAIN_D),
                        ("unet_leaf", UNET_ROWS, UNET_D)]:
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn((t, d), device=dev, generator=gen) * 3).to(dt)
            q, s = AC.quantize_rows(x)
            ok = k1_equals_plain(x, q, s)
            if not ok:
                fail(f"K1 disagrees with its plain version at {t} x {d} {dt}")
            args = AC.quantize_args(x, q, s)
            n = x.numel()
            entry = timed_bare(
                "K1 cut_quantize", k1_path(x), lambda: AC.quantize_rows(x),
                lambda: AC.QUANTIZE(*args), lambda: R.quantize_ref(x),
                bound("K1", t, d, x.element_size() * n, n + 4 * t), t, d, dt)
            del x, q, s
            if row is None:
                row = {"name": "cut_quantize", "route": "cuda",
                       "source": CUDA_SRC + "cut_layer.cu",
                       "replaces": "src/repro/kernels/act_compress/"
                                   "act_compress.py:37",
                       "launches": 0, "max_abs_err": err} | entry | {
                           "library_ms": None, "redesigned": "PR 19"}
                row.pop("shape")
            elif label == "main":
                row["bf16"] = entry
            elif dt == torch.float32:
                row["unet_leaf"] = entry
            else:
                row["unet_leaf"]["bf16"] = entry
    torch.cuda.empty_cache()
    return row


def timed_bare(label, path, wrapper, bare, plain, roofline, t, d, dt,
               library=None):
    """Time a row kernel's wrapper, its bare launch (outputs allocated
    once), its plain version and (if any) one PyTorch call that computes
    the same function, in the order plain, wrapper, bare, library, library,
    bare, wrapper, plain; each the mean of its pair, both of which are
    printed.  Returns the entry of the kernels line at this shape."""
    b_ms, b_by = roofline
    p0, w0 = cuda_ms(plain), cuda_ms(wrapper)
    k0 = cuda_ms(bare)
    lib = [cuda_ms(library), cuda_ms(library)] if library else []
    k1 = cuda_ms(bare)
    w1, p1 = cuda_ms(wrapper), cuda_ms(plain)
    entry = {"ms": (w0 + w1) / 2, "bare_ms": (k0 + k1) / 2,
             "plain_ms": (p0 + p1) / 2, "bound_ms": b_ms, "bound_by": b_by,
             "shape": [t, d]}
    said = ""
    if lib:
        entry["library_ms"] = sum(lib) / 2
        said = (f", one PyTorch call {entry['library_ms']:.4f} ms "
                f"({lib[0]:.4f}, {lib[1]:.4f})")
    log(f"  {label} {path}: bare {entry['bare_ms']:.4f} ms ({k0:.4f}, "
        f"{k1:.4f}; {100 * b_ms / entry['bare_ms']:.1f}% of the bound), "
        f"wrapper {entry['ms']:.4f} ms ({w0:.4f}, {w1:.4f}), plain "
        f"{entry['plain_ms']:.4f} ms ({p0:.4f}, {p1:.4f}){said}, bound "
        f"{b_ms:.4f} ms by {b_by} at {t} x {d} {str(dt)[6:]}")
    return entry


def level_rows(dev, gen, rows, d):
    """Levels and scales at K2's extremes: every row holds +127 and -127
    and otherwise levels drawn in [-127, 127], under scales spread
    log-uniformly from the smallest K1 gives (MIN_AMAX * INV_127, row 0)
    to 2^20 (the last row)."""
    import torch
    from repro_torch.kernels.act_compress import ref as R

    q = torch.randint(-127, 128, (rows, d), device=dev, generator=gen,
                      dtype=torch.int8)
    q[:, 0], q[:, -1] = 127, -127
    tiny = torch.tensor(R.MIN_AMAX, dtype=torch.float32) * R.INV_127
    s = torch.exp2(torch.linspace(math.log2(tiny.item()), 20, rows,
                                  device=dev))[:, None]
    s[0], s[-1] = tiny.item(), 2.0 ** 20
    return q, s


def check_k2(dev, gen, err):
    """K2 bit-equal to its plain version and to ``torch.mul(q, s,
    out=out)`` on every path of its design: the levels and scales the
    plain K1 makes of ``row_cases``'s rows and of D = 1024 (the misaligned
    case's q a view one byte past an allocation), zero rows to zeros, and
    ``level_rows`` at D = 160 and 161; each case on the path its plan
    says.  Then timed at the main path's shape and at the U-Net's widest
    leaf, into f32 and bf16, as wrapper calls, bare launches (out
    allocated once) and ``torch.mul`` (into a second out); returns K2's
    row of the kernels line."""
    import torch
    from repro_torch.kernels.act_compress import act_compress as AC
    from repro_torch.kernels.act_compress import ref as R

    rows = ROW_CASE_ROWS
    for dt in (torch.float32, torch.bfloat16):
        cases = []
        wide = (torch.randn((rows, 1024), device=dev, generator=gen)
                * 3).to(dt)
        for label, x, want in row_cases(dev, gen, dt) + [("D 1024", wide,
                                                          "vector")]:
            q, s = R.quantize_ref(x)
            if "misaligned" in label:
                q = misaligned(dev, torch.int8, rows, x.shape[1]).copy_(q)
                label = label.replace("view", "q view")
            cases.append((label, q, s, want))
        for d in (160, 161):
            cases.append((f"D {d}, levels +-127 under scales from MIN_AMAX "
                          "* INV_127 to 2^20", *level_rows(dev, gen, rows, d),
                          None))
        for label, q, s, want in cases:
            path = k2_path(q, dt)
            out = AC.dequantize_rows(q, s, dt)
            lib = torch.empty_like(out)
            torch.mul(q, s, out=lib)
            ok = torch.equal(out, R.dequantize_ref(q, s, dt))
            ok_lib = torch.equal(lib, out)
            torch.cuda.synchronize()
            if "zero" in label:
                ok = ok and not bool(out[::3].any())
            log(f"  K2 {str(dt)[6:]} {label}, {path}: {ok}; torch.mul "
                f"bit-equal {ok_lib}")
            if not ok or (want and not path.startswith(want)):
                fail(f"K2 at {label} {dt}: bit-equal {ok}, path {path} (want "
                     f"{want})")
    del cases, q, s, out, lib

    row = None
    for label, t, d in [("main", MAIN_ROWS, MAIN_D),
                        ("unet_leaf", UNET_ROWS, UNET_D)]:
        q, s = AC.quantize_rows(torch.randn((t, d), device=dev,
                                            generator=gen) * 3)
        n = q.numel()
        for dt in (torch.float32, torch.bfloat16):
            out, lib = (torch.empty((t, d), dtype=dt, device=dev)
                        for _ in range(2))
            args = AC.dequantize_args(q, s, out)
            AC.DEQUANTIZE(*args)
            same, max_abs = rows_vs_plain(
                out, lambda q, s: R.dequantize_ref(q, s, dt), q, s)
            same = same and torch.equal(AC.dequantize_rows(q, s, dt), out)
            torch.mul(q, s, out=lib)
            same_lib = torch.equal(lib, out)
            log(f"  K2 at {t} x {d} into {str(dt)[6:]}: bit-equal {same}; "
                f"torch.mul bit-equal {same_lib}")
            if not same:
                fail(f"K2 disagrees with its plain version at {t} x {d} {dt}")
            entry = timed_bare(
                "K2 cut_dequantize", k2_path(q, dt),
                lambda: AC.dequantize_rows(q, s, dt),
                lambda: AC.DEQUANTIZE(*args),
                lambda: R.dequantize_ref(q, s, dt),
                bound("K2", t, d, n + 4 * t, out.element_size() * n), t, d,
                dt, library=lambda: torch.mul(q, s, out=lib)) | {
                    "max_abs_err": max_abs, "library_bit_equal": same_lib}
            del out, lib
            if row is None:
                row = {"name": "cut_dequantize", "route": "cuda",
                       "source": CUDA_SRC + "cut_layer.cu",
                       "replaces": "src/repro/kernels/act_compress/"
                                   "act_compress.py:57",
                       "launches": 0} | entry | {
                           "max_abs_err": max(err, max_abs),
                           "redesigned": "PR 21"}
                row.pop("shape")
            elif label == "main":
                row["bf16"] = entry
            elif dt == torch.float32:
                row["unet_leaf"] = entry
            else:
                row["unet_leaf"]["bf16"] = entry
        del q, s
        torch.cuda.empty_cache()
    return row


def k3_equals_plain(x, out) -> bool:
    """K3's output ``out`` of the rows ``x`` (any shape, rows along the
    last axis) bit-equal to the plain version."""
    from repro_torch.kernels.act_compress import ref as R

    d = x.shape[-1]
    return rows_vs_plain(out.detach().reshape(-1, d), R.roundtrip_ref,
                         x.detach().reshape(-1, d))[0]


def row_weights(dev, gen, rows):
    """K4's row weights: all ones (today's callers), masked 0/1 (a padded
    batch) and fractional."""
    import torch

    return {"w ones": torch.ones((rows, 1), device=dev),
            "w masked": (torch.rand((rows, 1), device=dev, generator=gen)
                         < 0.6).float(),
            "w fractional": torch.rand((rows, 1), device=dev, generator=gen)}


def check_k3_k4(dev, gen):
    """K3 and K4 bit-equal to their plain versions on every path of their
    design (``row_cases``, and for K4 a z view off the 16-byte boundary,
    which takes the general path), K4 under each of ``row_weights``; each
    case on the path its plan says."""
    import torch
    from repro_torch.kernels.act_compress import ref as R
    from repro_torch.kernels.cut_fuse import cut_fuse as CF
    from repro_torch.kernels.cut_fuse import ref as RF

    rows = ROW_CASE_ROWS
    weights = row_weights(dev, gen, rows)
    for dt in (torch.float32, torch.bfloat16):
        cases = []
        for label, x, want in row_cases(dev, gen, dt):
            z = torch.randn(x.shape, device=dev, generator=gen) * 0.5
            cases.append((label, x, z, want, want))
        x = (torch.randn((rows, 160), device=dev, generator=gen) * 3).to(dt)
        z = misaligned(dev, torch.float32, rows, 160)
        z.copy_(torch.randn((rows, 160), device=dev, generator=gen) * 0.5)
        cases.append(("D 160, misaligned z view", x, z, "vector",
                      "general"))
        for label, x, z, want3, want4 in cases:
            p3, p4 = k3_path(x), k4_path(x, z)
            ok3 = torch.equal(CF.roundtrip_rows(x), R.roundtrip_ref(x))
            ok4 = {k: torch.equal(CF.noise_roundtrip_rows(x, z, w),
                                  RF.noise_roundtrip_ref(x, z, w))
                   for k, w in weights.items()}
            torch.cuda.synchronize()
            if "ties" in label:
                ties = tie_share(x, R.quantize_ref(x)[1])
                ok3 = ok3 and ties > 0.9
                label += f" ({100 * ties:.1f}% ties)"
            log(f"  K3/K4 {str(dt)[6:]} {label}: K3 {p3} {ok3}; K4 {p4} "
                + ", ".join(f"{k} {v}" for k, v in ok4.items()))
            if not (ok3 and all(ok4.values())) or (
                    want3 and not p3.startswith(want3)) or (
                    want4 and not p4.startswith(want4)):
                fail(f"K3/K4 at {label} {dt}: K3 bit-equal {ok3}, path {p3} "
                     f"(want {want3}); K4 {ok4}, path {p4} (want {want4})")
    torch.cuda.empty_cache()


def time_k3_k4(dev, gen, err):
    """K3 and K4, bit-equal to their plain versions first, then timed as
    wrapper calls and as bare launches (outputs allocated once) at the
    main path's shape and the U-Net's widest leaf in f32 and bf16, and K4
    at one hospital's rows of the private step (f32, its launch shape);
    returns their rows of the kernels line."""
    import torch
    from repro_torch.kernels.act_compress import ref as R
    from repro_torch.kernels.cut_fuse import cut_fuse as CF
    from repro_torch.kernels.cut_fuse import ref as RF

    rows = {key: {"name": name, "route": "cuda",
                  "source": CUDA_SRC + "cut_layer.cu",
                  "replaces": "src/repro/kernels/cut_fuse/cut_fuse.py:" + at,
                  "launches": 0, "max_abs_err": err[key]}
            for key, name, at in [("K3", "cut_roundtrip", "80"),
                                  ("K4", "cut_noise_roundtrip", "98")]}
    shapes = [("main", MAIN_ROWS, MAIN_D, torch.float32),
              ("main", MAIN_ROWS, MAIN_D, torch.bfloat16),
              ("unet_leaf", UNET_ROWS, UNET_D, torch.float32),
              ("unet_leaf", UNET_ROWS, UNET_D, torch.bfloat16),
              ("one_hospital", HOSPITAL_ROWS, MAIN_D, torch.float32)]
    for label, t, d, dt in shapes:
        x = (torch.randn((t, d), device=dev, generator=gen) * 3).to(dt)
        z = torch.randn((t, d), device=dev, generator=gen) * 0.5
        w = torch.ones((t, 1), device=dev)
        out = torch.empty_like(x)
        n, e = x.numel(), x.element_size()
        kernels = [
            ("K3", CF.roundtrip_rows, CF.ROUNDTRIP, CF.roundtrip_args,
             R.roundtrip_ref, (x,), k3_path(x), e * n),
            ("K4", CF.noise_roundtrip_rows, CF.NOISE_ROUNDTRIP,
             CF.noise_roundtrip_args, RF.noise_roundtrip_ref, (x, z, w),
             k4_path(x, z), (e + 4) * n + 4 * t)]
        for key, wrapper, kernel, args_of, plain, ins, path, nin in kernels:
            if label == "one_hospital" and key == "K3":
                continue
            same, max_abs = rows_vs_plain(wrapper(*ins), plain, *ins)
            args = args_of(*ins, out)
            kernel(*args)
            same = same and rows_vs_plain(out, plain, *ins)[0]
            if not same:
                fail(f"{key} disagrees with its plain version at {t} x {d} "
                     f"{dt}")
            entry = timed_bare(
                f"{key} {rows[key]['name']}", path, lambda: wrapper(*ins),
                lambda: kernel(*args), lambda: plain(*ins),
                bound(key, t, d, nin, e * n), t, d, dt) | {
                    "max_abs_err": max_abs}
            row = rows[key]
            worst = max(row["max_abs_err"], max_abs)
            if label == "main" and dt == torch.float32:
                entry.pop("shape")
                row.update(entry)
            elif label == "main":
                row["bf16"] = entry
            elif label == "unet_leaf" and dt == torch.float32:
                row["unet_leaf"] = entry
            elif label == "unet_leaf":
                row["unet_leaf"]["bf16"] = entry
            else:
                row[label] = entry
            row["max_abs_err"] = worst
        del x, z, w, out, kernels, ins
        torch.cuda.empty_cache()
    for row in rows.values():
        row |= {"library_ms": None, "redesigned": "PR 20"}
    return rows


def check_past_2_31(dev, gen):
    """K1, K2, K3 and K4 on WIDE_ROWS x 64 bf16, 2^31 + 512 elements: the
    last rows start past 2^31 elements, where a 32-bit row * D would wrap
    (K4's z past 2^33 bytes); bit-equal to their plain versions in every
    row (not timed)."""
    import torch
    from repro_torch.kernels.act_compress import act_compress as AC
    from repro_torch.kernels.act_compress import ref as R
    from repro_torch.kernels.cut_fuse import cut_fuse as CF
    from repro_torch.kernels.cut_fuse import ref as RF

    bf16 = torch.bfloat16
    x = torch.randn((WIDE_ROWS, UNET_D), device=dev, generator=gen,
                    dtype=bf16)
    ok3 = rows_vs_plain(CF.roundtrip_rows(x), R.roundtrip_ref, x)[0]
    torch.cuda.empty_cache()
    q, s = AC.quantize_rows(x)
    ok1 = k1_equals_plain(x, q, s)
    ok2 = rows_vs_plain(AC.dequantize_rows(q, s, bf16),
                        lambda q, s: R.dequantize_ref(q, s, bf16), q, s)[0]
    path2 = k2_path(q, bf16)
    del q, s
    torch.cuda.empty_cache()
    z = torch.randn((WIDE_ROWS, UNET_D), device=dev, generator=gen) * 0.5
    w = torch.rand((WIDE_ROWS, 1), device=dev, generator=gen)
    ok4 = rows_vs_plain(CF.noise_roundtrip_rows(x, z, w),
                        RF.noise_roundtrip_ref, x, z, w)[0]
    log(f"  ({WIDE_ROWS}, {UNET_D}) bf16, {x.numel()} elements: K3 "
        f"({k3_path(x)}) {ok3}, K1 ({k1_path(x)}) {ok1}, K2 ({path2}) {ok2}, "
        f"K4 ({k4_path(x, z)}, fractional w) {ok4}")
    del x, z, w
    torch.cuda.empty_cache()
    if not (ok3 and ok1 and ok2 and ok4):
        fail("K1, K2, K3 or K4 disagrees with its plain version past 2^31 "
             "elements")


def timed_row(key, name, source, replaces, kern, plain, library, shape,
              roofline, err):
    """Time a kernel, its plain version and (if any) one library call in
    the order plain, kernel, library, library, kernel, plain; each the
    mean of its pair, both of which are printed.  ``roofline``: (bound_ms,
    bound_by); ``shape``: the label of the timed shape."""
    p0, k0 = cuda_ms(plain), cuda_ms(kern)
    l0 = cuda_ms(library) if library else None
    l1 = cuda_ms(library) if library else None
    k1, p1 = cuda_ms(kern), cuda_ms(plain)
    b_ms, b_by = roofline
    row = {"name": name, "route": "cuda", "source": CUDA_SRC + source,
           "replaces": replaces, "launches": 0, "max_abs_err": err,
           "ms": (k0 + k1) / 2, "plain_ms": (p0 + p1) / 2, "bound_ms": b_ms,
           "bound_by": b_by,
           "library_ms": None if library is None else (l0 + l1) / 2}
    lib = ("" if library is None else f", one library call "
           f"{row['library_ms']:.4f} ms ({l0:.4f}, {l1:.4f})")
    log(f"  {key} {name}: {row['ms']:.4f} ms ({k0:.4f}, {k1:.4f}; plain "
        f"{row['plain_ms']:.4f} ms ({p0:.4f}, {p1:.4f}){lib}, bound "
        f"{b_ms:.4f} ms by {b_by}) at {shape}")
    return row


def rel_err(a, b) -> float:
    """max |a - b| over max |b| (the clip's sums cancel, so an elementwise
    relative error says nothing where b is near 0)."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


def check_dp_clip(dev, gen):
    """K5 and K6 over one hospital's per-example gradient table of
    DenseNet-121 (364 leaves, 16 x 6,948,609 f32) and a ragged small table:
    within 1e-6 relative of the same sums taken in double from the same f32
    leaves and scales (the kernels sum in double; an f32 sum's own rounding
    can exceed 1e-6 at a one-element leaf)."""
    import torch
    from repro_torch.configs.paper_models import DENSENET121_PAPER
    from repro_torch.core.partition import META, cnn_adapter
    from repro_torch.kernels.dp_clip import dp_clip as DC
    from repro_torch.kernels.dp_clip import ref as RD
    from repro_torch.models.cnn import build_densenet
    from repro_torch.tree import tree_leaves

    shapes = [tuple(l.shape) for l in tree_leaves(cnn_adapter(
        build_densenet(DENSENET121_PAPER)).init(None, META))]
    err = {"K5": 0.0, "K6": 0.0}
    for label, b, sizes in [
            ("real", BATCH, [math.prod(sh) for sh in shapes]),
            ("ragged", 3, [130, 7, 1, 5000, 4097, 33])]:
        leaves = [torch.randn((b, n), device=dev, generator=gen) * 0.01
                  for n in sizes]
        lt = DC.leaf_table(leaves)
        sq = DC.sqnorms_leaves(lt)
        sq_r = sum((l.double() ** 2).sum(-1) for l in leaves)
        scales = RD.clip_scales(sq_r.float().reshape(b, 1), 1.0)
        sums = DC.scale_accum_leaves(lt, scales)
        sums_r = [(l.double() * scales.double()).sum(0) for l in leaves]
        torch.cuda.synchronize()
        r5 = rel_err(sq, sq_r)
        r6 = max(rel_err(a, b_) for a, b_ in zip(sums, sums_r))
        err["K5"] = max(err["K5"], max_err(sq, sq_r))
        err["K6"] = max(err["K6"], max(max_err(a, b_)
                                       for a, b_ in zip(sums, sums_r)))
        log(f"  {label} table: {len(leaves)} leaves, {b} x {sum(sizes)} f32;"
            f" K5 relative error {r5:.3g}, K6 {r6:.3g} (limit 1e-6)")
        if not (r5 <= 1e-6 and r6 <= 1e-6):
            fail(f"K5/K6 disagree with their plain versions ({label})")
    # time over the real table; the library calls take the leaves
    # concatenated into one (16, 6,948,609) matrix.  The table is checked
    # and uploaded once per clip for both kernels (host work, timed apart)
    leaves_real = [torch.randn((BATCH, math.prod(sh)), device=dev,
                               generator=gen) for sh in shapes]
    big = torch.cat(leaves_real, dim=1)
    s = torch.rand((BATCH, 1), device=dev, generator=gen)
    n, d = big.numel(), big.shape[1]
    t0 = time.perf_counter()
    for _ in range(20):
        lt = DC.leaf_table(leaves_real)
    log(f"  leaf_table (check + upload of 364 leaves, host clock): "
        f"{(time.perf_counter() - t0) / 20 * 1e3:.4f} ms per clip")
    # K6 is timed as scale_accum_flat (the launch into one flat output);
    # scale_accum_leaves also cuts that output into 364 views, host work
    # that can outlast the kernel (CUDA events then time the host)
    log(f"  scale_accum_leaves (K6 + the 364 views): "
        f"{cuda_ms(lambda: DC.scale_accum_leaves(lt, s)):.4f} ms per call")
    table = {
        "K5": timed_row(
            "K5", "dp_sqnorms", "dp_clip.cu",
            "src/repro/kernels/dp_clip/dp_clip.py:44",
            lambda: DC.sqnorms_leaves(lt),
            lambda: sum(RD.sqnorms_ref(l) for l in leaves_real),
            lambda: torch.linalg.vecdot(big, big), f"{BATCH} x {d} f32",
            bound("K5", BATCH, d, 4 * n, 4 * BATCH), err["K5"]),
        "K6": timed_row(
            "K6", "dp_scale_accum", "dp_clip.cu",
            "src/repro/kernels/dp_clip/dp_clip.py:62",
            lambda: DC.scale_accum_flat(lt, s),
            lambda: [RD.scale_accum_ref(l, s) for l in leaves_real],
            lambda: s.reshape(1, BATCH) @ big, f"{BATCH} x {d} f32",
            bound("K6", BATCH, d, 4 * n + 4 * BATCH, 4 * d), err["K6"]),
    }
    return table


# K9's shapes: (label, (N, C, H, W), channels_last): a hospital's U-Net
# front at 768^2 x 64 (its first norm reads the segment's channels_last
# input), the server's decoder at batch 10, and DenseNet-121's middle at
# batch 80 (the first norm at 56^2 x 160 channels_last, a bottleneck norm,
# 28^2, and 7^2, whose planes are not whole 4-element vectors)
K9_SHAPES = [("unet front", (2, 64, 768, 768), False),
             ("unet front first", (2, 64, 768, 768), True),
             ("unet decoder", (10, 64, 768, 768), False),
             ("densenet middle first", (80, 160, 56, 56), True),
             ("densenet bottleneck", (80, 128, 56, 56), False),
             ("densenet 28^2", (80, 256, 28, 28), False),
             ("densenet 7^2", (80, 1024, 7, 7), False)]


def k9_inputs(dev, gen, shape, cl, dt=None):
    import torch
    x = torch.randn(shape, device=dev, generator=gen) * 2 + 0.5
    x = x.to(dt) if dt is not None else x
    if cl:
        x = x.to(memory_format=torch.channels_last)
    return (x, torch.randn(shape[1], device=dev, generator=gen),
            torch.randn(shape[1], device=dev, generator=gen))


def check_group_norm(dev, gen):
    """K9 (GroupNorm + ReLU) bit-equal to ATen's ``F.relu(F.group_norm(
    ...))`` (the pair it replaced; its mean and rstd to ``native_group_norm
    ``'s) at ``K9_SHAPES`` in f32 and bf16 (through f32, as the model runs
    it), and within an ulp of its plain version at the U-Net front; then
    timed in f32 at each shape beside its byte bound (8 bytes an f32
    element: x read once, y written once; the two passes of its design move
    12), ATen's pair, and (once, at the front) the plain version, whose
    chains are a Python loop of 9,216 steps.  The table's row is the U-Net
    front's; the other shapes are under ``shapes``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.group_norm import group_norm as GN
    from repro_torch.kernels.group_norm import ref as RG

    for label, shape, cl in K9_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x, gamma, beta = k9_inputs(dev, gen, shape, cl, dt)
            y, m, r = GN.group_norm_relu_fwd(x, gamma, beta, 8, 1e-5)
            xf = x.float()
            pair = F.relu(F.group_norm(xf, 8, gamma, beta, 1e-5)).to(dt)
            n, c, h, w = shape
            _, am, ar = torch.ops.aten.native_group_norm(
                xf.contiguous(), gamma, beta, n, c, h * w, 8, 1e-5)
            torch.cuda.synchronize()
            ok = (torch.equal(y, pair) and torch.equal(m, am)
                  and torch.equal(r, ar) and y.is_contiguous())
            log(f"  K9 {label} {tuple(shape)} "
                f"{'channels_last' if cl else 'NCHW'} {str(dt)[6:]}: "
                f"bit-equal to ATen's pair {ok} (y max abs "
                f"{max_err(y, pair):.3g}, mean {max_err(m, am):.3g}, rstd "
                f"{max_err(r, ar):.3g})")
            if not ok:
                fail(f"K9 differs from ATen's GroupNorm + ReLU at {label} "
                     f"{str(dt)[6:]}")
            del x, xf, y, pair
    x, gamma, beta = k9_inputs(dev, gen, K9_SHAPES[0][1], False)
    y, m, r = GN.group_norm_relu_fwd(x, gamma, beta, 8, 1e-5)
    t0 = time.perf_counter()
    py, pm, pr = RG.group_norm_relu_ref(x, gamma, beta, 8, 1e-5)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(max_err(y, py), max_err(m, pm), max_err(r, pr))
    ulp = 2.0 ** -23
    log(f"  K9 against its plain version at the U-Net front: y max abs "
        f"{max_err(y, py):.3g}, mean {max_err(m, pm):.3g}, rstd "
        f"{max_err(r, pr):.3g}; the plain version {plain_ms:.1f} ms "
        f"(host clock, once)")
    if not (((m - pm).abs() <= ulp * pm.abs()).all()
            and ((r - pr).abs() <= ulp * pr).all()
            and ((y - py).abs() <= 4 * ulp * py.abs() + 1e-7).all()):
        fail("K9 parts from its plain version by more than an ulp")
    del x, y, py
    rows = {}
    for label, shape, cl in K9_SHAPES:
        x, gamma, beta = k9_inputs(dev, gen, shape, cl)
        n = x.numel()
        def kern():
            return GN.group_norm_relu_fwd(x, gamma, beta, 8, 1e-5)

        def aten():
            return F.relu(F.group_norm(x, 8, gamma, beta, 1e-5))
        k0, a0, a1, k1 = cuda_ms(kern), cuda_ms(aten), cuda_ms(aten), \
            cuda_ms(kern)
        b_ms, b_by = roof(8 * n, [(4 * n, F32_OPS_PER_S)])
        two_pass = 12 * n / HBM_BYTES_PER_S * 1e3
        row = {"name": "group_norm_relu", "route": "cuda",
               "source": CUDA_SRC + "group_norm.cu",
               "replaces": "none (XLA's GroupNorm)", "launches": 0,
               "max_abs_err": err, "ms": (k0 + k1) / 2,
               "plain_ms": plain_ms if label == "unet front" else None,
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": (a0 + a1) / 2}
        log(f"  K9 group_norm_relu: {row['ms']:.4f} ms ({k0:.4f}, "
            f"{k1:.4f}; ATen's pair {row['library_ms']:.4f} ms ({a0:.4f}, "
            f"{a1:.4f}), bound {b_ms:.4f} ms by {b_by}: "
            f"{100 * b_ms / row['ms']:.1f}%, the two passes' {two_pass:.4f}"
            f" ms: {100 * two_pass / row['ms']:.1f}%) at {label} "
            f"{tuple(shape)} {'channels_last' if cl else 'NCHW'} f32")
        rows[label] = row
        del x
    table = dict(rows["unet front"])
    table["shapes"] = {k: {f: v[f] for f in ("ms", "library_ms",
                                             "bound_ms")}
                       for k, v in rows.items() if k != "unet front"}
    return {"K9": table}


# K9 runs at every GroupNorm of the CNNs (phases 5, 6 and 9 hold its
# launches); phases 12 and 14 hold a replay's launches of the cut-layer
# and DP kernels alone
K9_SYMBOLS = ("group_norm_relu_stats", "group_norm_relu_apply",
              "group_norm_to_nchw")


def without_k9(per: dict) -> dict:
    """A replay's launches (``Program.per_replay``) but K9's."""
    return {k: v for k, v in per.items() if k not in K9_SYMBOLS}


GN_FORWARD_ATEN = ("RowwiseMoments", "ComputeFusedParams",
                   "GroupNormKernelImpl", "GroupNorm1dForward")


def k9_sites(params) -> int:
    """GroupNorm layers in a segment's params."""
    return sum(1 for unit in params.values() for layer in unit.values()
               if set(layer) == {"scale", "bias"})


def k9_step_sites(adapter, n) -> int:
    """GroupNorms that one SFLv3 step of ``n`` hospitals runs forward:
    each hospital's front (and tail, NLS), the server's middle once."""
    import torch
    params = adapter.init(None, torch.device("meta"))
    return sum(k9_sites(p) * (1 if seg == "middle" else n)
               for seg, p in params.items())


def k9_count(label, stats, apply, want=None):
    """K9's two kernels launched alike, at least once, and ``want`` times
    each where it is given."""
    if stats != apply or not stats or (want is not None and stats != want):
        fail(f"{label}: K9 launched stats {stats}, apply {apply}; expected "
             f"{'as many' if want is None else want} of each")


def aten_group_norm_free(call, label):
    """Profile ``call()`` (one replay): K9's kernels run in it, and no
    forward kernel of ATen's GroupNorm."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if getattr(e, "device_type", None) == DeviceType.CUDA}
    aten = sorted(n for n in names if any(f in n for f in GN_FORWARD_ATEN))
    ours = sorted(n for n in names if "group_norm" in n)
    log(f"    ATen GroupNorm forward kernels in a profiled replay: "
        f"{aten or 'none'}; K9's: {len(ours)} kernels")
    if aten or not ours:
        fail(f"{label}: ATen's GroupNorm forward ran ({aten}) or K9 did "
             "not")


def seq_inner(t):
    """The same values with the q axis (2) innermost in memory, as the
    model's conv lays out xbar, B and C."""
    order = [a for a in range(t.dim()) if a != 2] + [2]
    return t.permute(order).contiguous().permute(
        [order.index(a) for a in range(t.dim())])


def ssd_inputs(dev, gen, b, nc, q, h, p, g, n, dt, skew=0, slow=False,
               model_layout=False):
    """K8's inputs on ``dev`` from ``gen``, as mamba_apply makes them:
    xbar = x * dt, la = -dt * A (A from 1 to 16), B and C column slices of
    one (.., 2 g n + h + skew) tensor (skew 1 makes their rows unaligned:
    the kernel's scalar path); with ``model_layout`` xbar and that tensor
    have the q axis innermost, as in the model.  dt is softplus(randn), as
    this repo's random-weight Mamba2 (dt_bias 0) makes it, or with
    ``slow`` log-uniform in [1e-3, 1e-1], the published Mamba2's
    initialisation: there L = exp(cs_i - cs_j) stays near 1 across the
    chunk, so every tile of C B^T reaches y_intra."""
    import torch
    x = torch.randn((b, nc, q, h, p), device=dev, generator=gen)
    r = torch.rand((b, nc, q, h), device=dev, generator=gen) if slow \
        else torch.randn((b, nc, q, h), device=dev, generator=gen)
    dtv = 1e-3 * 100.0 ** r if slow else torch.nn.functional.softplus(r)
    A = torch.linspace(1.0, 16.0, h, device=dev)
    conv = torch.randn((b, nc, q, 2 * g * n + h + skew), device=dev,
                       generator=gen).to(dt)
    xbar = x * dtv[..., None]
    if model_layout:
        xbar, conv = seq_inner(xbar), seq_inner(conv)
    return (xbar, -dtv * A,
            conv[..., :g * n].unflatten(-1, (g, n)),
            conv[..., g * n:2 * g * n].unflatten(-1, (g, n)))


def check_lm_kernels(dev, gen):
    """K7 and K8 against their plain versions (f32 on the card: no TF32),
    at the reference's kernel-test shapes with its bars (K7 2e-6 in f32,
    2e-2 in bf16; K8 3e-4), at small ragged shapes, and at the scoring
    shape of phase 7 in model layout; then timed at the scoring shape (K8
    with bf16 B/C, its row, and with f32 B/C, printed)."""
    import torch
    from repro_torch.device import use_full_fp32
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.ssd_scan import ref as SR
    from repro_torch.kernels.ssd_scan import ssd_scan as SS

    use_full_fp32(dev)
    err = {"K7": 0.0, "K8": 0.0}

    def attn_inputs(b, h, kv, s, d, dt):
        # model layout (B, S, H, D) in memory, as the path hands them over
        return [torch.randn((b, s, n, d), device=dev, generator=gen).to(
            dt).transpose(1, 2) for n in (h, kv, kv)]

    # (shape, causal, dtype, bar): at the scoring shape the f32 sums run
    # over up to 2048 keys in another order than the plain version's:
    # 1e-5 in f32; bf16 keeps the reference's 2e-2 (the tensor-core kernel
    # rounds P to bf16 before P V, then the output once).  The bf16 cases
    # hold the tensor-core kernel at head_dim 32, 64 and 128 and at ragged
    # last tiles (S 80 and 96 are not multiples of its 64-row tiles)
    cases = [((1, 2, 1, 128, 64), c, dt, 2e-6 if dt == torch.float32
              else 2e-2) for c in (True, False)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [((2, 4, 2, 256, 64), True, torch.float32, 2e-6),
              ((2, 4, 2, 256, 64), False, torch.bfloat16, 2e-2),
              ((1, 6, 2, 80, 32), True, torch.float32, 2e-6),    # ragged GQA
              ((1, 6, 2, 80, 32), True, torch.bfloat16, 2e-2),
              ((1, 4, 1, 96, 128), False, torch.bfloat16, 2e-2),
              ((1, 4, 1, 96, 128), True, torch.bfloat16, 2e-2),
              (LM_ATTN, True, torch.float32, 1e-5),
              (LM_ATTN, True, torch.bfloat16, 2e-2)]
    # At the scoring shape a causal row averages v over up to 2048 keys,
    # so late rows are of order 0.03 and the absolute bf16 bar alone would
    # miss a 64-key tile dropped from them: there each row's error is also
    # held relative to the row, ||out - ref|| / ||ref|| (bar K7_ROW_REL)
    for shape, causal, dt, bar in cases:
        q, k, v = attn_inputs(*shape, dt)
        out = FA.flash_attention_bhsd(q, k, v, causal)
        ref = FR.flash_attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        e = max_err(out, ref)
        err["K7"] = max(err["K7"], e)
        rbar = K7_ROW_REL if shape == LM_ATTN and dt == torch.bfloat16 \
            else None
        r = float(((out.float() - ref.float()).norm(dim=-1)
                   / ref.float().norm(dim=-1).clamp_min(1e-30)).max())
        log(f"  K7 {shape} {'causal' if causal else 'full'} "
            f"{str(dt)[6:]}: max |kernel - plain| {e:.3g} (bar {bar:g}); "
            f"largest row-relative error {r:.3g}"
            + ("" if rbar is None else f" (bar {rbar:g})"))
        if not (out.dtype == dt and e <= bar
                and (rbar is None or r <= rbar)):
            fail(f"K7 disagrees with its plain version at {shape}")

    # (dims, B/C dtype, skew, slow, model layout): bf16 runs C B^T on the
    # tensor cores, in partial (masked, zero-filled) tiles where q or n is
    # not a multiple of 16 (q 8, 24, 12; n 20); B/C and xbar are staged
    # along their rows (copy mode 1), down their columns (2: the model's
    # layout), or by scalar loads (0: skew 1, 2 g n + h odd, or 12-row
    # columns in the model's layout)
    cases = [((1, 4, 16, 2, 16, 1, 16), torch.float32, 0, False, False),
             ((1, 3, 32, 3, 16, 1, 64), torch.float32, 0, False, False),
             ((2, 3, 8, 8, 32, 2, 16), torch.bfloat16, 0, False, False),
             ((2, 3, 8, 8, 32, 2, 16), torch.bfloat16, 1, False, False),
             ((2, 3, 8, 8, 32, 2, 16), torch.bfloat16, 0, False, True),
             ((1, 2, 24, 4, 32, 2, 32), torch.bfloat16, 0, False, False),
             ((1, 2, 24, 4, 32, 2, 32), torch.bfloat16, 4, False, False),
             ((1, 2, 24, 4, 32, 2, 32), torch.bfloat16, 0, False, True),
             ((1, 2, 24, 4, 32, 2, 32), torch.float32, 0, False, False),
             ((1, 2, 24, 4, 32, 2, 32), torch.float32, 0, False, True),
             ((1, 2, 12, 2, 12, 1, 20), torch.bfloat16, 0, False, False),
             ((1, 2, 12, 2, 12, 1, 20), torch.bfloat16, 0, False, True),
             ((1, 2, 12, 2, 12, 1, 20), torch.float32, 0, False, False),
             (LM_SSD, torch.float32, 0, False, False),
             (LM_SSD, torch.bfloat16, 0, False, False),
             (LM_SSD, torch.float32, 0, True, False),
             (LM_SSD, torch.bfloat16, 0, True, False),
             (LM_SSD, torch.float32, 0, False, True),
             (LM_SSD, torch.bfloat16, 0, False, True),
             (LM_SSD, torch.bfloat16, 0, True, True)]
    for dims, dt, skew, slow, model_layout in cases:
        args = ssd_inputs(dev, gen, *dims, dt, skew, slow, model_layout)
        got, want = SS.ssd_chunk(*args), SR.ssd_chunk_ref(*args)
        torch.cuda.synchronize()
        ok = all(torch.allclose(a, b, atol=3e-4, rtol=3e-4)
                 for a, b in zip(got, want))
        e = max(max_err(a, b) for a, b in zip(got, want))
        err["K8"] = max(err["K8"], e)
        modes = SS.kernel_dims(*args)[26:]
        log(f"  K8 {dims} B/C {str(dt)[6:]} (copy modes B/C {modes[0]}, "
            f"xbar {modes[1]}{', dt in [1e-3, 1e-1]' if slow else ''}): max "
            f"|kernel - plain| {e:.3g}, within atol = rtol = 3e-4: {ok}")
        if not ok:
            fail(f"K8 disagrees with its plain version at {dims}")

    # timed at the scoring shape, bf16 as the path runs them
    q, k, v = attn_inputs(*LM_ATTN, torch.bfloat16)
    b, h, kv, s, d = LM_ATTN
    o = torch.empty_like(q)
    pairs = b * h * s * (s + 1) // 2             # causal: keys j <= i
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, o))
    table = {"K7": timed_row(
        "K7", "flash_attention_fwd", "flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:86",
        lambda: FA.flash_attention_bhsd(q, k, v, True),
        lambda: FR.flash_attention_ref(q, k, v, True),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
        f"{LM_ATTN} bf16 causal",
        roof(nbytes, [(4 * d * pairs, BF16_OPS_PER_S)]), err["K7"])}
    del q, k, v, o
    # timed at the scoring shape in the model's layout with bf16 B/C, as the
    # path runs it (the row); then printed: the row-major layout, and f32
    # B/C (C B^T on the CUDA cores, one block an SM)
    b, nc, qq, h, p, g, n = LM_SSD
    tri = b * nc * h * qq * (qq + 1) // 2        # (i, j) with j <= i
    for dt, model_layout in ((torch.bfloat16, True), (torch.bfloat16, False),
                             (torch.float32, True)):
        args = ssd_inputs(dev, gen, *LM_SSD, dt, model_layout=model_layout)
        outs = SS.ssd_chunk(*args)
        nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs))
        bf16 = dt == torch.bfloat16
        label = (f"{LM_SSD} B/C {str(dt)[6:]}, "
                 f"{'model' if model_layout else 'row-major'} layout")
        log(f"  K8 at {label}: copy modes {SS.kernel_dims(*args)[26:]}, "
            f"{SS.blocks_per_sm(*args)} blocks an SM")
        row = timed_row(
            "K8", "ssd_chunk_fwd", "ssd_scan.cu",
            "src/repro/kernels/ssd_scan/ssd_scan.py:61",
            lambda: SS.ssd_chunk(*args), lambda: SR.ssd_chunk_ref(*args),
            None, label,
            roof(nbytes, [(2 * tri * n,
                           BF16_OPS_PER_S if bf16 else F32_OPS_PER_S),
                          (2 * tri * p + 2 * b * nc * h * qq * n * p,
                           F32_OPS_PER_S)]), err["K8"])
        table.setdefault("K8", row)
        del args, outs
    return table


# ---------------------------------------------------------------------------
# phases 4 and 5: the SplitFedv3 slice
# ---------------------------------------------------------------------------

def train(method, adapter, clients, batch, device, fuse=True, seed=0,
          step_seconds=None, codec="int8", privacy=None, n_train=None,
          transport=None, step_launches=None):
    """Build a method of the Table-2 grid as a user would, on the stepwise
    engine (phases 4-8; phase 9 runs the compiled one beside it), and
    train one epoch (on the first ``n_train`` train images of each
    hospital, all by default), over ``Transport(codec)`` (``codec`` None:
    no transport, as centralized and FL have no cut layer); with a list
    ``step_seconds`` each step is timed on the host clock between two
    device synchronisations, and with a list ``step_launches`` too, each
    step's launches of ``path_kernels`` are appended to it.  ``privacy``:
    PrivacyConfig keywords; ``transport``: a Transport to use instead of
    ``Transport(codec)``."""
    import numpy as np
    import torch

    from repro_torch import optim as O
    from repro_torch.core.strategies import make_strategy
    from repro_torch.privacy import PrivacyConfig
    from repro_torch.wire import Transport

    if transport is None and codec is not None:
        transport = Transport(codec, fuse=fuse, device=device)
    strat = make_strategy(
        method, adapter, lambda: O.adam(1e-4), len(clients),
        transport=transport, device=device, engine="stepwise",
        privacy=None if privacy is None else PrivacyConfig(**privacy))
    if step_seconds is not None:
        step = strat._step
        kernels = path_kernels()

        def timed(*args, **kw):
            before = {n: k.launches for n, k in kernels.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args, **kw)
            torch.cuda.synchronize()
            step_seconds.append(time.perf_counter() - t0)
            if step_launches is not None:
                step_launches.append({n: k.launches - before[n]
                                      for n, k in kernels.items()})
            return out
        strat._step = timed
    state = strat.setup(seed)
    data = [{k: v[:n_train] for k, v in c.train.items()} for c in clients]
    state, epoch = strat.run_epoch(state, data, np.random.default_rng(1),
                                   batch)
    return strat, state, epoch, transport


def sflv3(cfg, clients, batch, device, fuse, **kw):
    """SplitFedv3 (``sflv3_ac``) on a DenseNet config, the LS cut."""
    from repro_torch.core.partition import cnn_adapter
    from repro_torch.models.cnn import build_densenet
    return train("sflv3_ac", cnn_adapter(build_densenet(cfg)), clients,
                 batch, device, fuse, **kw)


def small_against_cpu(dev):
    """DenseNet-mini at 32^2 on the card and on the CPU (plain path) from
    the same seed, over an identity link: losses and scores within 1e-4
    (float32 round-off of cuDNN's and ATen's convolutions, as the CPU
    tests allow against the JAX package).  Over the int8 link only the
    first step's losses are held to 1e-4 and the rest is printed: a
    cut-tensor element within round-off of a half level lands on the
    neighbouring level on one side, and Adam turns that into another
    update, so later steps measure the link's sensitivity, not the port's
    arithmetic (phase 3 holds the kernels bit for bit)."""
    import numpy as np

    from repro_torch.configs.paper_models import DENSENET_MINI
    from repro_torch.data.synthetic import make_cxr_clients

    clients = make_cxr_clients(seed=0, n_clients=5, train_per_client=8,
                               val_per_client=6, test_per_client=6,
                               image_size=32)
    for codec in ("identity", "int8"):
        out = {}
        for device in ("cpu", dev):
            strat, state, epoch, _ = sflv3(DENSENET_MINI, clients, 4, device,
                                           fuse=True, codec=codec)
            out[torch_type(device)] = (
                np.asarray(epoch.losses).reshape(epoch.steps, -1),
                np.concatenate(strat.scores_all(state,
                                                [c.test for c in clients])))
        dl = np.abs(out["cpu"][0] - out["cuda"][0]).max(axis=1)
        ds = float(np.abs(out["cpu"][1] - out["cuda"][1]).max())
        log(f"  mini 32^2 over {codec}: |loss card - cpu| by step "
            f"{dl.tolist()}, |score card - cpu| {ds:.3g}")
        if not np.isfinite(out["cuda"][0]).all():
            fail(f"non-finite losses on the card over {codec}")
        if codec == "identity" and not (dl.max() <= 1e-4 and ds <= 1e-4):
            fail("the card's SplitFedv3 run disagrees with the CPU's")
        if dl[0] > 1e-4:        # step 1: the same params on both sides
            fail(f"the card's first-step losses over {codec} disagree "
                 "with the CPU's")

    # the private step (DP-SGD through vmap(grad), K5/K6; K3 or K1/K2
    # under vmap on the int8 link), deterministic: noise 0, C = 1.  Every
    # step is held over the identity link, the first over int8 (as above)
    priv = dict(noise_multiplier=0.0, clip_norm=1.0, cut_noise_std=0.0)
    for codec, fuse in [("identity", True), ("int8", True), ("int8", False)]:
        out = {}
        for device in ("cpu", dev):
            _, _, epoch, _ = sflv3(DENSENET_MINI, clients[:3], 2, device,
                                   fuse=fuse, codec=codec, privacy=priv,
                                   n_train=4)
            out[torch_type(device)] = np.asarray(epoch.losses).reshape(
                epoch.steps, -1)
        dl = np.abs(out["cpu"] - out["cuda"]).max(axis=1)
        log(f"  mini 32^2 private (noise 0, C 1) over {codec}"
            f"{'' if codec == 'identity' else (' fused' if fuse else ' unfused')}"
            f": |loss card - cpu| by step {dl.tolist()}")
        held = dl if codec == "identity" else dl[:1]
        if not np.isfinite(out["cuda"]).all() or held.max() > 1e-4:
            fail("the card's private step disagrees with the CPU's")


# the methods of the Table-2 grid held card against CPU in phase 4, beside
# sflv3_ac above: (method, family, nls)
GRID_SMALL = [("centralized", "densenet", False), ("fl", "densenet", False),
              ("sl_ac", "densenet", False), ("sl_am", "densenet", False),
              ("sflv2_ac", "densenet", False), ("sflv2_ac", "densenet", True),
              ("sflv1_ac", "densenet", False), ("sflv1_ac", "densenet", True),
              ("sl_am", "unet", False), ("sl_am", "unet", True),
              ("sflv3_ac", "unet", False), ("sflv3_ac", "unet", True)]


def small_adapter(family, nls):
    from repro_torch.configs.paper_models import DENSENET_MINI, UNET_MINI
    from repro_torch.core.partition import cnn_adapter
    from repro_torch.models.cnn import build_densenet, build_unet
    if family == "densenet":
        return cnn_adapter(build_densenet(DENSENET_MINI, nls=nls))
    return cnn_adapter(build_unet(UNET_MINI, nls=nls))


def grid_small_against_cpu(dev):
    """2 steps of each method of ``GRID_SMALL`` at 32^2, 2 hospitals, batch
    4, on the card and on the CPU from the same seed, under the bars of
    ``small_against_cpu``: without a transport or over an identity link
    every step's losses and the scores within 1e-4; over the int8 link
    (fused) the first step's losses within 1e-4 and the rest printed."""
    import numpy as np

    from repro_torch.data.synthetic import make_cxr_clients

    clients = make_cxr_clients(seed=0, n_clients=2, train_per_client=8,
                               val_per_client=6, test_per_client=6,
                               image_size=32)
    batch = 4
    for method, family, nls in GRID_SMALL:
        sync = method.startswith(("sflv3", "sflv1"))
        n_train = 2 * batch if sync else batch      # 2 steps either way
        codecs = ([None] if method in ("centralized", "fl")
                  else ["identity", "int8"])
        for codec in codecs:
            out = {}
            for device in ("cpu", dev):
                strat, state, epoch, _ = train(
                    method, small_adapter(family, nls), clients, batch,
                    device, codec=codec, n_train=n_train)
                out[torch_type(device)] = (
                    np.asarray(epoch.losses).reshape(epoch.steps, -1),
                    np.concatenate(strat.scores_all(
                        state, [c.test for c in clients])))
            dl = np.abs(out["cpu"][0] - out["cuda"][0]).max(axis=1)
            ds = float(np.abs(out["cpu"][1] - out["cuda"][1]).max())
            log(f"  {method} {family}-mini {'NLS' if nls else 'LS'} over "
                f"{codec or 'no link'}: |loss card - cpu| by step "
                f"{dl.tolist()}, |score card - cpu| {ds:.3g}")
            if len(dl) != 2 or not np.isfinite(out["cuda"][0]).all():
                fail(f"{method}: expected 2 finite steps on the card")
            if codec != "int8" and not (dl.max() <= 1e-4 and ds <= 1e-4):
                fail(f"the card's {method} run disagrees with the CPU's")
            if dl[0] > 1e-4:
                fail(f"the card's first-step losses of {method} over "
                     f"{codec} disagree with the CPU's")


def torch_type(device) -> str:
    import torch
    return torch.device(device).type


def main_data(steps):
    """The 5 synthetic hospitals of the main paths at 224^2."""
    from repro_torch.data.synthetic import make_cxr_clients

    t0 = time.perf_counter()
    clients = make_cxr_clients(seed=0, n_clients=5,
                               train_per_client=steps * BATCH,
                               val_per_client=BATCH, test_per_client=BATCH,
                               image_size=224)
    log(f"  data: 5 hospitals x {steps * BATCH} train images at 224^2 "
        f"({time.perf_counter() - t0:.1f} s)")
    return clients


def path_kernels():
    from repro_torch.kernels.act_compress import act_compress as AC
    from repro_torch.kernels.cut_fuse import cut_fuse as CF
    from repro_torch.kernels.dp_clip import dp_clip as DC
    from repro_torch.kernels.group_norm import group_norm as GN
    return {"K1": AC.QUANTIZE, "K2": AC.DEQUANTIZE, "K3": CF.ROUNDTRIP,
            "K4": CF.NOISE_ROUNDTRIP, "K5": DC.SQNORMS,
            "K6": DC.SCALE_ACCUM, "K9 stats": GN.STATS,
            "K9 apply": GN.APPLY}


def run_path(label, clients, dev, fuse, privacy=None, n_train=None):
    """One epoch of the main path; returns (strategy, state, per-step
    losses, launches of each kernel in this run).  Every step launches
    K9's two kernels alike, once per GroupNorm of each forward without
    ``privacy`` (the hospitals' fronts, the server's middle)."""
    import numpy as np
    import torch

    from repro_torch.configs.paper_models import DENSENET121_PAPER

    kernels = path_kernels()
    torch.cuda.reset_peak_memory_stats()
    before = {n: k.launches for n, k in kernels.items()}
    step_s, step_n = [], []
    strat, state, epoch, tr = sflv3(DENSENET121_PAPER, clients, BATCH, dev,
                                    fuse, step_seconds=step_s,
                                    privacy=privacy, n_train=n_train,
                                    step_launches=step_n)
    counts = {n: k.launches - before[n] for n, k in kernels.items()}
    losses = np.asarray(epoch.losses).reshape(epoch.steps, -1)
    log(f"  sflv3_ac {label}: {epoch.steps} steps, step seconds "
        f"{[round(x, 4) for x in step_s]}, step-1 losses "
        f"{losses[0].tolist()}")
    log(f"    launches {' '.join(f'{n} {c}' for n, c in counts.items())}; "
        f"transport {json.dumps(tr.summary())}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not np.isfinite(losses).all():
        fail(f"non-finite losses in the {label} run")
    sites = None if privacy else k9_step_sites(strat.adapter, len(clients))
    log(f"    K9 a step (stats, apply): "
        f"{[(n['K9 stats'], n['K9 apply']) for n in step_n]}"
        + ("" if privacy else f"; {sites} GroupNorms a step"))
    for n in step_n:
        k9_count(f"{label}, a step", n["K9 stats"], n["K9 apply"], sites)
    return strat, state, losses, counts


def evaluate(strat, state, clients):
    val = strat.val_loss(state, clients)
    metrics = strat.evaluate(state, clients)
    log(f"  val_loss {val:.6f}; evaluate {json.dumps(metrics)}")
    if not math.isfinite(val) or not all(map(math.isfinite,
                                             metrics.values())):
        fail("non-finite validation loss or metrics")


def reset_launches():
    for k in path_kernels().values():
        k.launches = 0


def main_path(dev, clients, profile):
    """Phase 5: the non-private path, unfused (K1, K2) then fused (K3)."""
    import numpy as np

    reset_launches()
    runs = {}
    for fuse in (False, True):
        strat, state, runs[fuse], _ = run_path(
            "fused (K3)" if fuse else "unfused (K1, K2)", clients, dev, fuse)
    evaluate(strat, state, clients)     # the fused strategy, the default
    launches = {n: k.launches for n, k in path_kernels().items()
                if n in ("K1", "K2", "K3", "K9 stats", "K9 apply")}
    if not np.array_equal(runs[True][0], runs[False][0]):
        fail("first-step losses differ between the fused and unfused runs")
    if not all(launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    if profile:
        profile_step(strat, state, clients, BATCH, "fused")
    return launches


def private_path(dev, clients, profile):
    """Phase 6: DP-SGD + cut-layer noise over the int8 link, unfused (K1, K2
    + the masked add, K5, K6) then fused (K4, K5, K6), 2 steps each; then
    cut-layer noise alone (DP off), one K4 launch per step.  Returns the
    launches of K1, K2 and K4-K6 in the phase."""
    import numpy as np

    n = len(clients)
    reset_launches()
    runs = {}
    expect = {False: {"K1": 1, "K2": 1, "K5": 1, "K6": 1},
              True: {"K4": 1, "K5": 1, "K6": 1}}
    for fuse in (False, True):
        label = ("private fused (K4, K5, K6)" if fuse
                 else "private unfused (K1, K2 + add, K5, K6)")
        strat, state, runs[fuse], counts = run_path(
            label, clients, dev, fuse, PRIVACY, 2 * BATCH)
        report = strat.privacy_report()
        log(f"    privacy_report {json.dumps(report)}")
        if len(report) != n or not all(
                math.isfinite(r["epsilon"]) and r["epsilon"] > 0
                for r in report):
            fail("privacy_report lacks a finite epsilon for a hospital")
        # every hospital, every step: one launch of each of its kernels
        want = {k: expect[fuse].get(k, 0) * n * len(runs[fuse])
                for k in ("K1", "K2", "K3", "K4", "K5", "K6")}
        counts = {k: counts[k] for k in want}
        if counts != want:
            fail(f"{label}: launches {counts}, expected {want}")
    evaluate(strat, state, clients)
    if not np.array_equal(runs[True][0], runs[False][0]):
        fail("first-step losses differ between the private fused and "
             "unfused runs")
    _, _, losses, counts = run_path(
        "cut noise only (K4)", clients, dev, True,
        dict(cut_noise_std=PRIVACY["cut_noise_std"], seed=0), 2 * BATCH)
    if counts["K4"] != len(losses) or counts["K5"] or counts["K6"]:
        fail(f"cut noise alone should launch K4 once per step: {counts}")
    launches = {k: v.launches for k, v in path_kernels().items()
                if k in ("K1", "K2", "K4", "K5", "K6")}
    if not all(launches.values()):
        fail(f"a kernel of the private path never launched: {launches}")
    if profile:
        profile_step(strat, state, clients, BATCH, "private fused")
    return launches


# ---------------------------------------------------------------------------
# phase 8: the Table-2 grid at full width
# ---------------------------------------------------------------------------

# (method, nls) of each family's runs; the split family over the int8 link
DENSE_GRID = [(m, False) for m in ("centralized", "fl", "sl_ac", "sl_am",
                                   "sflv2_ac", "sflv3_ac", "sflv1_ac")] + [
    ("sl_am", True), ("sflv2_ac", True), ("sflv3_ac", True)]
UNET_GRID = [("sflv3_ac", False), ("sflv3_ac", True), ("sl_am", False),
             ("sl_am", True)]


def grid_run(method, nls, adapter, clients, batch, dev, profile=False):
    """One epoch of one grid row (2 batches per hospital) and its checks:
    finite losses; K3 launched once per boundary leaf per crossing per
    step (no launch without a link); the transport's bytes equal to
    ``comm_per_epoch``'s train legs for the batches run; K3's output at
    every boundary leaf of the first step (each crossing) bit-equal to its
    plain version on the same rows (held inside that step, so its time
    counts in step 1's seconds); SFLv2/v1 hospitals hold one client tree
    after the epoch and SL/SFLv3 distinct ones; ``evaluate`` finite.
    With ``profile``, one more step runs under the profiler.  Returns the
    run's K1-K3 launches."""
    import numpy as np
    import torch

    from repro_torch.core.comm import comm_per_epoch
    from repro_torch.tree import tree_leaves
    from repro_torch.wire import Transport

    kernels = {k: v for k, v in path_kernels().items()
               if k in ("K1", "K2", "K3")}
    split = method not in ("centralized", "fl")
    example = {k: v[:batch] for k, v in clients[0].train.items()}
    specs = adapter.boundary_specs(example)
    leaves = sum(len(tree_leaves(t)) for t in specs.values())
    tr = Transport("int8", device=dev) if split else None
    held = held_leaves(tr, leaves) if split else []
    torch.cuda.reset_peak_memory_stats()
    before = {n: k.launches for n, k in kernels.items()}
    step_s = []
    strat, state, epoch, tr = train(method, adapter, clients, batch, dev,
                                    codec=None, transport=tr,
                                    n_train=2 * batch, step_seconds=step_s)
    counts = {n: k.launches - before[n] for n, k in kernels.items()}
    label = f"{method} {'NLS' if nls else 'LS'}"
    per_step = len(epoch.losses) // epoch.steps
    log(f"  {label}: {epoch.steps} steps, step seconds "
        f"{[round(x, 4) for x in step_s]}, step-1 losses "
        f"{epoch.losses[:per_step]}")
    log(f"    launches {' '.join(f'{n} {c}' for n, c in counts.items())}; "
        f"transport {json.dumps(tr.summary() if split else None)}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not np.isfinite(epoch.losses).all():
        fail(f"{label}: non-finite losses")
    if split:
        log(f"    K3 == plain at step 1's leaves: "
            f"{' '.join(f'{tuple(s)} {ok} {p}' for s, ok, p in held)}")
        if len(held) != leaves or not all(ok for _, ok, _ in held):
            fail(f"{label}: K3 disagrees with its plain version at a "
                 "boundary leaf of the first step, or a leaf went unheld")
        if not all(p.startswith("vector") for _, _, p in held):
            fail(f"{label}: K3 took its general path at a boundary leaf")
    want = {"K1": 0, "K2": 0, "K3": leaves * epoch.steps if split else 0}
    if counts != want:
        fail(f"{label}: launches {counts}, expected {want}")
    if split:
        comm = comm_per_epoch(method, adapter, example,
                              [2 * batch] * len(clients),
                              [len(c.val["label"]) for c in clients], batch,
                              codec=tr.codec)
        legs = sum(v for k, v in comm.breakdown.items()
                   if k.startswith("train_"))
        if tr.bytes_on_wire != legs:
            fail(f"{label}: {tr.bytes_on_wire} bytes on the wire, "
                 f"comm_per_epoch's train legs {legs}")
        trees = [tree_leaves(c) for c in state["clients"]]
        same = [all(torch.equal(a, b) for a, b in zip(t, trees[0]))
                for t in trees[1:]]
        if method.startswith(("sflv2", "sflv1")) and not all(same):
            fail(f"{label}: the hospitals' client trees differ after the "
                 "epoch's sync")
        if method.startswith(("sl_", "sflv3")) and any(same):
            fail(f"{label}: two hospitals hold the same client tree")
    evaluate(strat, state, clients)
    if profile:
        profile_step(strat, state, clients, batch,
                     f"{label} at {UNET_SIZE}^2, one batch per hospital,")
    return counts


def held_leaves(transport, n):
    """Hold K3's output at the first ``n`` leaves ``transport`` sends (the
    first step's boundary leaves, every crossing) against its plain version
    on the same rows; the output the step uses is the one held, so this
    launches nothing.  Returns the list of (shape, equal, path) it
    fills."""
    codec, held = transport.codec, []
    fused = codec.fused_roundtrip

    def checked(x):
        out = fused(x)
        if len(held) < n:
            held.append((tuple(x.shape), k3_equals_plain(x, out),
                         k3_path(x)))
        return out
    codec.fused_roundtrip = checked
    return held


def grid_path(dev, clients, profile=False):
    """Phase 8: every method of the grid on DenseNet-121 at 224^2 (5
    hospitals x 2 batches of 16, LS, and NLS for sl_am, sflv2_ac and
    sflv3_ac), then sflv3_ac and sl_am on the paper's U-Net at 768^2 (5
    hospitals x 2 batches of UNET_BATCH, LS and NLS).  Returns the K1-K3
    launches of the phase.  ``profile`` profiles one more step of the
    U-Net's sflv3_ac and sl_am, LS."""
    import torch

    from repro_torch.configs.paper_models import DENSENET121_PAPER, UNET_PAPER
    from repro_torch.core.partition import cnn_adapter
    from repro_torch.data.synthetic import make_cxr_clients
    from repro_torch.models.cnn import build_densenet, build_unet

    reset_launches()
    total = {"K1": 0, "K2": 0, "K3": 0}
    for method, nls in DENSE_GRID:
        counts = grid_run(method, nls, cnn_adapter(build_densenet(
            DENSENET121_PAPER, nls=nls)), clients, BATCH, dev)
        total = {k: total[k] + counts[k] for k in total}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    unet_clients = make_cxr_clients(
        seed=0, n_clients=5, train_per_client=2 * UNET_BATCH,
        val_per_client=UNET_BATCH, test_per_client=UNET_BATCH,
        image_size=UNET_SIZE)
    log(f"  data: 5 hospitals x {2 * UNET_BATCH} train images at "
        f"{UNET_SIZE}^2 ({time.perf_counter() - t0:.1f} s)")
    for method, nls in UNET_GRID:
        counts = grid_run(method, nls, cnn_adapter(build_unet(
            UNET_PAPER, nls=nls)), unet_clients, UNET_BATCH, dev,
            profile and not nls)
        total = {k: total[k] + counts[k] for k in total}
        torch.cuda.empty_cache()
    log(f"  launches in phase 8: {total}")
    if not total["K3"]:
        fail("K3 never launched on the grid")
    return total


# ---------------------------------------------------------------------------
# phase 9: the compiled engine at full width
# ---------------------------------------------------------------------------

# (method, nls, precision, options) of each family's runs: every grid row
# of phase 8 in f32 and bf16 on DenseNet-121, the private SFLv3 step in
# f32, the unfused int8 link (K1, K2) on bf16 rows, 3-epoch runs of SFLv3
# and FL; the U-Net rows in bf16, and its SFLv3 rows in f32 too (captured,
# the f32 step peaks at 56-60 GiB of the card's 80: PERF.md, PR 18)
COMPILED_DENSE = (
    [(m, nls, p, {}) for p in ("fp32", "bf16") for m, nls in DENSE_GRID]
    + [("sflv3_ac", False, "fp32", {"privacy": PRIVACY}),
       ("sflv3_ac", False, "bf16", {"fuse": False}),
       ("sflv3_ac", False, "fp32", {"epochs": 3}),
       ("fl", False, "fp32", {"epochs": 3})])
COMPILED_UNET = ([(m, nls, "bf16", {}) for m, nls in UNET_GRID]
                 + [("sflv3_ac", False, "fp32", {}),
                    ("sflv3_ac", True, "fp32", {})])


@contextlib.contextmanager
def timed_programs(calls):
    """Time every call of a compiled program (one step or round replay,
    the first of each body with its warm-up and capture) on the host
    clock between two device synchronisations: ``calls`` gets (body,
    seconds, captured in this call)."""
    import torch

    from repro_torch.core.strategies import engine as ENG

    orig = ENG.Program.__call__

    def timed(self, name):
        fresh = name not in self.graphs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig(self, name)
        torch.cuda.synchronize()
        calls.append((name, time.perf_counter() - t0, fresh))
    ENG.Program.__call__ = timed
    try:
        yield
    finally:
        ENG.Program.__call__ = orig


@contextlib.contextmanager
def captured_k2_plans(plans):
    """Append to ``plans`` the plan (``act_compress.dequantize_plan``) of
    every K2 launch made while a CUDA graph is being captured: the plan
    its replays keep."""
    import torch

    from repro_torch.kernels.act_compress import act_compress as AC

    orig = AC.dequantize_plan

    def record(*args):
        plan = orig(*args)
        if torch.cuda.is_current_stream_capturing():
            plans.append(plan)
        return plan
    AC.dequantize_plan = record
    try:
        yield
    finally:
        AC.dequantize_plan = orig


def captured_leaves(transport):
    """Keep the (input, output) of every K3 (or K1/K2 pair) call the
    transport's codec makes while a CUDA graph is being captured: the
    graph's own buffers, which every replay rewrites in place.  Holding
    them keeps the allocator from reusing their memory inside the
    capture; after a replay they hold that replay's cut tensors."""
    import torch

    codec, held = transport.codec, []
    for attr in ("fused_roundtrip", "roundtrip"):
        fn = getattr(codec, attr)

        def keep(x, fn=fn):
            out = fn(x)
            if torch.cuda.is_current_stream_capturing():
                held.append((x, out))
            return out
        setattr(codec, attr, keep)
    return held


def engine_run(engine, method, nls, adapter, clients, batch, dev, precision,
               privacy=None, fuse=True, epochs=1, opt_factory=None):
    """``epochs`` epochs of one grid row on ``engine`` from seed 0 (2
    batches per hospital an epoch), with ``Strategy.run`` (the optimizer
    ``opt_factory`` makes, ``adam(1e-4)`` by default); returns a dict
    of the strategy, state, logs, transport, step seconds (stepwise: each
    step; compiled: each replay, and the first call of each body apart),
    the run's wall time, peak memory, the K3 pairs captured and the plans
    of the K2 launches captured."""
    import numpy as np
    import torch

    from repro_torch import optim as O
    from repro_torch.core.strategies import make_strategy
    from repro_torch.privacy import PrivacyConfig
    from repro_torch.wire import Transport

    split = method not in ("centralized", "fl")
    tr = Transport("int8", fuse=fuse, device=dev) if split else None
    held = captured_leaves(tr) if split and engine == "compiled" else []
    strat = make_strategy(
        method, adapter, opt_factory or (lambda: O.adam(1e-4)), len(clients),
        transport=tr,
        privacy=None if privacy is None else PrivacyConfig(**privacy),
        engine=engine, precision=precision, device=dev)
    calls, step_s, k2_plans = [], [], []
    if engine == "stepwise":
        step = strat._step

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args, **kw)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out
        strat._step = timed
    state = strat.setup(0)
    data = [{k: v[:2 * batch] for k, v in c.train.items()} for c in clients]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        if engine == "compiled":
            stack.enter_context(timed_programs(calls))
            stack.enter_context(captured_k2_plans(k2_plans))
        t0 = time.perf_counter()
        state, logs = strat.run(state, data, np.random.default_rng(1), batch,
                                epochs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if engine == "compiled":
        step_s = [t for name, t, fresh in calls if name == "step"
                  and not fresh]
    return dict(strat=strat, state=state, logs=logs, tr=tr, wall=wall,
                step_s=step_s, peak=torch.cuda.max_memory_allocated(),
                first=[(name, t) for name, t, fresh in calls if fresh],
                held=held, k2_plans=k2_plans)


def engine_pair(method, nls, precision, opts, adapter, clients, batch, dev,
                profile=False):
    """One phase-9 run: the stepwise and the compiled engine from the same
    start, and their checks.  ``opts`` may name the run's optimizer
    (``opt``, a factory, and ``opt_label``; ``adam(1e-4)`` otherwise).

    Bar: equal.  Phase 9 runs with ``cudnn.deterministic`` (cuDNN's
    default weight-gradient algorithms add in a run-dependent order), so
    the stepwise engine repeats itself bit for bit; the compiled step
    replays the same kernels on the same inputs, so every loss, every
    param of every hospital and epsilon must be the stepwise engine's
    exactly, and the wire bytes equal ``comm_per_epoch``'s train legs.
    The compiled run must be ONE program (one capture per body: the step,
    and the round of FL/SFLv2/SFLv1), K3 must launch once per boundary
    leaf and replay (K4/K5/K6 once per hospital on the private step),
    and K3's output at every boundary leaf of the last replay must be
    bit-equal to its plain version on the graph's own input buffer (over
    the unfused link K2(K1)'s, each K2 captured on its vector path)."""
    import numpy as np
    import torch

    from repro_torch.core.comm import comm_per_epoch
    from repro_torch.tree import tree_leaves

    epochs, fuse = opts.get("epochs", 1), opts.get("fuse", True)
    privacy = opts.get("privacy")
    label = (f"{method} {'NLS' if nls else 'LS'} {precision}"
             + (" private" if privacy else "")
             + (f" {opts['opt_label']}" if "opt" in opts else "")
             + ("" if fuse else " unfused") + (f" x{epochs} epochs"
                                                if epochs > 1 else ""))
    runs = {}
    for engine in ("stepwise", "compiled"):
        runs[engine] = engine_run(engine, method, nls, adapter, clients,
                                  batch, dev, precision, privacy, fuse,
                                  epochs, opts.get("opt"))
        torch.cuda.empty_cache()
    sw, cp = runs["stepwise"], runs["compiled"]
    strat = cp["strat"]
    progs = list(strat._programs.values())
    prog = progs[0]
    bodies = len(prog.bodies)
    step = prog.per_replay.get("step", {})
    per = without_k9(step)
    k9 = [step.get(sym, 0) for sym in K9_SYMBOLS]
    dl = max(float(np.abs(np.asarray(a.losses) - np.asarray(b.losses))
                   .max()) for a, b in zip(sw["logs"], cp["logs"]))
    dp, same = 0.0, True
    for c in range(len(clients)):
        for a, b in zip(tree_leaves(sw["strat"].params_for_eval(
                sw["state"], c)), tree_leaves(strat.params_for_eval(
                cp["state"], c))):
            same = same and torch.equal(a, b)
            dp = max(dp, float((a - b).abs().max()))
    log(f"  {label}: step seconds stepwise "
        f"{[round(x, 4) for x in sw['step_s']]}, compiled "
        f"{[round(x, 4) for x in cp['step_s']]} (first call of each body, "
        f"with warm-up and capture: "
        f"{[(n, round(t, 3)) for n, t in cp['first']]}); run wall "
        f"{sw['wall']:.3f} / {cp['wall']:.3f} s; peak "
        f"{sw['peak'] / 2**30:.2f} / {cp['peak'] / 2**30:.2f} GiB")
    sflv3_ls = method == "sflv3_ac" and not privacy
    sites = k9_step_sites(adapter, len(clients)) if sflv3_ls else None
    log(f"    compiled: {len(progs)} program, {prog.captures} captures, "
        f"per replay {json.dumps(per)}, K9 stats {k9[0]} apply {k9[1]} "
        f"(channels_last inputs copied {k9[2]})"
        + (f" for {sites} GroupNorms" if sites else "")
        + f"; |loss diff| {dl:.3g}, |param diff| {dp:.3g}")
    k9_count(f"{label}, a replay", k9[0], k9[1], sites)
    if len(progs) != 1 or prog.captures != bodies:
        fail(f"{label}: {len(progs)} programs and {prog.captures} captures;"
             f" expected one program captured once per body ({bodies})")
    if not (dl == 0 and same and all(
            a.losses == b.losses and a.weights == b.weights
            and a.client_steps == b.client_steps
            for a, b in zip(sw["logs"], cp["logs"]))):
        fail(f"{label}: the compiled engine disagrees with the stepwise one")
    if not all(np.isfinite(l.losses).all() for l in cp["logs"]):
        fail(f"{label}: non-finite losses")
    if privacy and sw["strat"].privacy_report() != strat.privacy_report():
        fail(f"{label}: epsilon differs between the engines")
    split = method not in ("centralized", "fl")
    if split:
        example = {k: v[:batch] for k, v in clients[0].train.items()}
        leaves = sum(len(tree_leaves(t)) for t in
                     strat.adapter.boundary_specs(example).values())
        comm = comm_per_epoch(method, strat.adapter, example,
                              [2 * batch] * len(clients),
                              [len(c.val["label"]) for c in clients], batch,
                              codec=cp["tr"].codec)
        legs = epochs * sum(v for k, v in comm.breakdown.items()
                            if k.startswith("train_"))
        if not cp["tr"].bytes_on_wire == sw["tr"].bytes_on_wire == legs:
            fail(f"{label}: wire bytes {cp['tr'].bytes_on_wire} compiled, "
                 f"{sw['tr'].bytes_on_wire} stepwise, comm_per_epoch's "
                 f"train legs {legs}")
        n = len(clients)
        if privacy:
            want = {"cut_noise_roundtrip": n, "dp_sqnorms": n,
                    "dp_scale_accum": n}
        elif fuse:
            want = {"cut_roundtrip": leaves}
        else:
            want = {"cut_quantize": leaves, "cut_dequantize": leaves}
        if per != want:
            fail(f"{label}: launches per replay {per}, expected {want}")
        held = cp["held"]
        ok = [k3_equals_plain(x, out) for x, out in held]
        log(f"    K3 == plain at the last replay's {len(ok)} leaves: "
            f"{all(ok)}")
        if not privacy and (len(ok) != leaves or not all(ok)):
            fail(f"{label}: the link disagrees with its plain version on "
                 "the graph's buffers, or a leaf went unheld")
        if not fuse:
            paths = [row_path(p) for p in cp["k2_plans"]]
            log(f"    K2 at the captured step's {len(paths)} leaves: "
                f"{paths}")
            if len(paths) != leaves or not all(
                    p.startswith("vector") for p in paths):
                fail(f"{label}: a leaf's K2 was captured off the vector "
                     "path, or went unrecorded")
    elif per:
        fail(f"{label}: a kernel launched without a cut layer: {per}")
    evaluate(strat, cp["state"], clients)
    if sflv3_ls and not nls and precision == "fp32" and fuse \
            and epochs == 1:
        prog.t.zero_()
        aten_group_norm_free(lambda: prog("step"), label)
    if profile:
        prog.t.zero_()
        profile_call(lambda: prog("step"), f"{label} replayed step",
                     KERNEL_GROUPS)
    del runs, sw, cp, strat, progs, prog
    torch.cuda.empty_cache()


def compiled_path(dev, clients, profile=False):
    """Phase 9: the compiled engine against the stepwise one on every run
    of ``COMPILED_DENSE`` (DenseNet-121 at 224^2, 5 hospitals x 2 batches
    of 16) and ``COMPILED_UNET`` (the U-Net at 768^2, 5 x 2 batches of
    UNET_BATCH), each checked by ``engine_pair``.  Returns the launches of
    K1-K6 in the phase.  ``profile`` profiles one replayed step of the
    private SFLv3 run and of SL-AM (LS, f32)."""
    import torch

    from repro_torch.configs.paper_models import DENSENET121_PAPER, UNET_PAPER
    from repro_torch.core.partition import cnn_adapter
    from repro_torch.data.synthetic import make_cxr_clients
    from repro_torch.models.cnn import build_densenet, build_unet

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        reset_launches()
        for method, nls, precision, opts in COMPILED_DENSE:
            engine_pair(method, nls, precision, opts, cnn_adapter(
                build_densenet(DENSENET121_PAPER, nls=nls)), clients, BATCH,
                dev, profile and ("privacy" in opts or (
                    method == "sl_am" and not nls and precision == "fp32")))
        unet_clients = make_cxr_clients(
            seed=0, n_clients=5, train_per_client=2 * UNET_BATCH,
            val_per_client=UNET_BATCH, test_per_client=UNET_BATCH,
            image_size=UNET_SIZE)
        for method, nls, precision, opts in COMPILED_UNET:
            engine_pair(method, nls, precision, opts, cnn_adapter(
                build_unet(UNET_PAPER, nls=nls)), unet_clients, UNET_BATCH,
                dev)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    launches = {k: v.launches for k, v in path_kernels().items()}
    log(f"  launches in phase 9: {launches}")
    if not all(launches.values()):
        fail(f"a kernel of the compiled path never launched: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 11: the private grid at full width
# ---------------------------------------------------------------------------

PRIVATE_DP = dict(noise_multiplier=1.1, clip_norm=1.0)
PRIVATE_CUT = dict(PRIVATE_DP, cut_noise_std=0.5)
# train images per hospital: 2 batches of 16 and, where the method keeps
# it (drop_remainder=False; SFLv3/v1 refuse it and drop it), one of 8
PRIVATE_N = 40
# (method, nls, privacy): DP-SGD on centralized and FL, DP-SGD + cut noise
# on the split family (LS, and NLS for SL-AC and SFLv3), cut noise alone
# on SL-AM (K4 then takes the remainder batch's 0/1 row weights; under DP
# the estimator weights the examples and K4's rows are all 1), and FL
# with secure aggregation
PRIVATE_GRID = [("centralized", False, PRIVATE_DP), ("fl", False, PRIVATE_DP),
                ("sl_ac", False, PRIVATE_CUT), ("sl_am", False, PRIVATE_CUT),
                ("sflv2_ac", False, PRIVATE_CUT), ("sl_ac", True, PRIVATE_CUT),
                ("sflv3_ac", True, PRIVATE_CUT),
                ("sl_am", False, dict(cut_noise_std=0.5)),
                ("fl", False, dict(PRIVATE_DP, secagg=True))]
# compiled against stepwise where a batch is padded: the padded step runs
# its convolutions on 16 rows (8 of them zero) against the stepwise
# engine's 8, so cuDNN may add in another order, and Adam can turn such a
# round-off into a move of up to lr (1e-4) where a tiny gradient changes
# sign; on an NVIDIA H100 the DP rows read 0 and cut noise alone 2.16e-5
# in a param (PERF.md, Findings)
PADDED_BAR = 1e-4
PRIVATE_KERNELS = ("cut_noise_roundtrip", "dp_sqnorms", "dp_scale_accum")


@contextlib.contextmanager
def captured_k4_weights(held):
    """Append to ``held`` the row-weight tensor of every K4 launch made
    while a CUDA graph is being captured: the graph's own buffer, which
    every replay rewrites (holding it keeps the allocator from reusing it
    inside the capture), so after a run it holds the last replay's row
    weights."""
    import torch

    from repro_torch.kernels.cut_fuse import ops

    orig = ops.noise_roundtrip_rows

    def keep(x, z, w):
        if torch.cuda.is_current_stream_capturing():
            held.append(w)
        return orig(x, z, w)
    ops.noise_roundtrip_rows = keep
    try:
        yield
    finally:
        ops.noise_roundtrip_rows = orig


def private_run(engine, method, nls, privacy, adapter, clients, dev):
    """One epoch of a private grid row on ``engine`` from seed 0 (the first
    ``PRIVATE_N`` train images of each hospital, remainder batches kept
    where the method allows), with ``Strategy.run``; returns the strategy,
    state, log, the step seconds (stepwise: each step; compiled: each
    replay), the first call of each body, the run's wall time and peak
    memory, the private kernels' launches in the run, the K4 row weights
    captured and the stepwise engine's steps."""
    import numpy as np
    import torch

    from repro_torch import optim as O
    from repro_torch.core.strategies import make_strategy
    from repro_torch.kernels import build as B
    from repro_torch.privacy import PrivacyConfig
    from repro_torch.wire import Transport

    split = method not in ("centralized", "fl")
    keep = not method.startswith(("sflv3", "sflv1"))
    strat = make_strategy(
        method, adapter, lambda: O.adam(1e-4), len(clients),
        transport=Transport("int8", device=dev) if split else None,
        privacy=PrivacyConfig(**privacy), engine=engine,
        drop_remainder=not keep, device=dev)
    calls, step_s, weights = [], [], []
    if engine == "stepwise":
        step = strat._step

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args, **kw)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out
        strat._step = timed
    state = strat.setup(0)
    data = [{k: v[:PRIVATE_N] for k, v in c.train.items()} for c in clients]
    kernels = {k.symbol: k for k in B.CudaKernel.instances
               if k.symbol in PRIVATE_KERNELS}
    before = {n: k.launches for n, k in kernels.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        if engine == "compiled":
            stack.enter_context(timed_programs(calls))
            stack.enter_context(captured_k4_weights(weights))
        t0 = time.perf_counter()
        state, logs = strat.run(state, data, np.random.default_rng(1), BATCH,
                                1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if engine == "compiled":
        step_s = [t for name, t, fresh in calls if name == "step"
                  and not fresh]
    return dict(strat=strat, state=state, log=logs[0], step_s=step_s,
                first=[(name, t) for name, t, fresh in calls if fresh],
                wall=wall, peak=torch.cuda.max_memory_allocated(),
                launches={n: k.launches - before[n]
                          for n, k in kernels.items()},
                weights=weights)


def private_pair(method, nls, privacy, clients, dev, profile=False):
    """One phase-11 row: the stepwise and the compiled engine from the same
    start, and their checks.

    Bars: where no batch is padded (SFLv3, which drops the remainder, and
    every step before a row's first padded step) every loss, and for
    SFLv3 every param, equal; where one is, losses and params within
    ``PADDED_BAR``.  Epsilon per hospital equal, and FL's secure
    aggregation metered the same.  The compiled run is one program
    captured once per body; each replay launches K5/K6 once per DP clip
    (once a step, SFLv3 once per hospital) and K4 once per boundary leaf
    and crossing with cut noise (SFLv3: per hospital too); the stepwise
    engine the same per step.  Cut noise without DP captures K4 with the
    remainder batch's 0/1 row weights."""
    import numpy as np
    import torch

    from repro_torch.configs.paper_models import DENSENET121_PAPER
    from repro_torch.core.partition import cnn_adapter
    from repro_torch.models.cnn import build_densenet
    from repro_torch.tree import tree_leaves

    adapter = cnn_adapter(build_densenet(DENSENET121_PAPER, nls=nls))
    label = (f"{method} {'NLS' if nls else 'LS'} "
             + "+".join(k for k in ("noise_multiplier", "cut_noise_std",
                                    "secagg") if privacy.get(k)))
    runs = {}
    for engine in ("stepwise", "compiled"):
        runs[engine] = private_run(engine, method, nls, privacy, adapter,
                                   clients, dev)
        torch.cuda.empty_cache()
    sw, cp = runs["stepwise"], runs["compiled"]
    strat = cp["strat"]
    progs = list(strat._programs.values())
    prog = progs[0]
    per = {k: v for k, v in prog.per_replay.get("step", {}).items()
           if k in PRIVATE_KERNELS}
    la, lb = np.asarray(sw["log"].losses), np.asarray(cp["log"].losses)
    w = sw["log"].weights
    padded = [i for i, m in enumerate(w or []) if m < BATCH]
    first = padded[0] if padded else len(la)
    dl = float(np.abs(la - lb).max())
    dp, same = 0.0, True
    for c in range(len(clients)):
        for a, b in zip(tree_leaves(sw["strat"].params_for_eval(
                sw["state"], c)), tree_leaves(strat.params_for_eval(
                cp["state"], c))):
            same = same and torch.equal(a, b)
            dp = max(dp, float((a - b).abs().max()))
    n_steps = sw["log"].steps
    sw_per = {k: v / n_steps for k, v in sw["launches"].items()}
    log(f"  {label}: {n_steps} steps ({len(padded)} padded), step seconds "
        f"stepwise {[round(x, 4) for x in sw['step_s']]}, replayed "
        f"{[round(x, 4) for x in cp['step_s']]} (first call of each body: "
        f"{[(n, round(t, 3)) for n, t in cp['first']]}); run wall "
        f"{sw['wall']:.3f} / {cp['wall']:.3f} s; peak "
        f"{sw['peak'] / 2**30:.2f} / {cp['peak'] / 2**30:.2f} GiB")
    log(f"    launches per stepwise step {json.dumps(sw_per)}, per replay "
        f"{json.dumps(per)}; |loss diff| {dl:.3g} (steps before the first "
        f"padded one: {first}), |param diff| {dp:.3g}; epsilon "
        f"{[round(r['epsilon'], 6) for r in strat.privacy_report()]}")
    if len(progs) != 1 or prog.captures != len(prog.bodies):
        fail(f"{label}: {len(progs)} programs and {prog.captures} captures")
    if not np.array_equal(la[:first], lb[:first]) or (
            not padded and not same):
        fail(f"{label}: the engines differ where no batch is padded")
    if padded and max(dl, dp) > PADDED_BAR:
        fail(f"{label}: the engines differ by more than {PADDED_BAR} over "
             "the padded steps")
    if not (np.isfinite(lb).all() and cp["log"].weights == w):
        fail(f"{label}: non-finite losses or other step weights")
    if sw["strat"].privacy_report() != strat.privacy_report():
        fail(f"{label}: epsilon differs between the engines")
    if privacy.get("noise_multiplier") and not all(
            0 < r["epsilon"] < math.inf for r in strat.privacy_report()):
        fail(f"{label}: a hospital lacks a finite epsilon")
    if privacy.get("secagg") and (
            sw["strat"].secagg.summary() != strat.secagg.summary()
            or strat.secagg.rounds != 1):
        fail(f"{label}: secure aggregation metered differently")
    hospitals = len(clients) if method.startswith("sflv3") else 1
    crossings = 2 if nls else 1
    want = {}
    if privacy.get("cut_noise_std"):
        want["cut_noise_roundtrip"] = hospitals * crossings
    if privacy.get("noise_multiplier"):
        want.update(dp_sqnorms=hospitals, dp_scale_accum=hospitals)
    if per != want or {k: v for k, v in sw_per.items() if v} != want:
        fail(f"{label}: launches per replay {per} and per stepwise step "
             f"{sw_per}, expected {want}")
    if privacy.get("cut_noise_std") and not privacy.get("noise_multiplier"):
        ws = [float(x.min()) for x in cp["weights"]]
        share = [round(float(x.mean()), 4) for x in cp["weights"]]
        log(f"    K4 row weights of the last replay (a remainder step): "
            f"min {ws}, mean {share}")
        if not ws or not all(m == 0.0 for m in ws):
            fail(f"{label}: K4 was not captured with the padded rows' 0 "
                 "weights")
    evaluate(strat, cp["state"], clients)
    if profile:
        prog.t.zero_()
        profile_call(lambda: prog("step"), f"{label} replayed step",
                     KERNEL_GROUPS)
    del runs, sw, cp, strat, progs, prog
    torch.cuda.empty_cache()


def private_grid_path(dev, clients, profile=False):
    """Phase 11: every row of ``PRIVATE_GRID`` on DenseNet-121 at 224^2, 5
    hospitals of ``PRIVATE_N`` images at batch 16, over the fused int8
    link, on both engines from the same start (``private_pair``), under
    cuDNN's deterministic algorithms.  Returns the launches of K4-K6 in
    the phase.  ``profile`` profiles one replayed step of the centralized
    and the SL-AC (LS) rows."""
    import torch

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        reset_launches()
        for method, nls, privacy in PRIVATE_GRID:
            private_pair(method, nls, privacy, clients, dev,
                         profile and method in ("centralized", "sl_ac")
                         and not nls)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    launches = {k: v.launches for k, v in path_kernels().items()
                if k in ("K4", "K5", "K6")}
    log(f"  launches in phase 11: {json.dumps(launches)}")
    if not all(launches.values()):
        fail(f"a kernel of the private grid never launched: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 12: participation and the aggregation rules at full width
# ---------------------------------------------------------------------------

PART_N = 10                   # hospitals of the K-of-N rows and the rules
PART_K = 4                    # hospitals sampled a round in the K-of-N rows
PART_IMAGES = 2 * BATCH       # train images per hospital: 2 batches of 16
PART_ROUNDS = 2
# (a) each method under Participation(k=N) against participation=None
PART_KN = ("fl", "sl_ac", "sflv2_ac", "sflv3_ac")
# (b) the K-of-N rows: (method, privacy)
PART_KOFN = [("fl", PRIVATE_DP), ("sl_am", PRIVATE_CUT),
             ("sflv3_ac", PRIVATE_CUT), ("sflv2_ac", dict(cut_noise_std=0.5))]
# (c) FL over the PART_N hospitals, RULE_K sampled a round, under each rule
# (and the median again at an even count, PART_K)
RULE_K, RULE_ROUNDS = 5, 3
RULE_REGIONS = (0, 0, 0, 1, 1, 1, 2, 2, 2, 2)
# the captured round against the rule in float64 on the host: the largest
# |difference| over the largest |row| of each leaf (every rule's output is
# a combination of its rows, so their size sets the scale)
RULE_BAR = 1e-6


def rules():
    """(rule, hospitals sampled a round) of phase 12 (c)."""
    from repro_torch.core import aggregate as AGG
    return [(AGG.TrimmedMean(0.2), RULE_K), (AGG.CoordinateMedian(), RULE_K),
            (AGG.StalenessDiscounted(0.5), RULE_K),
            (AGG.Hierarchical(RULE_REGIONS), RULE_K),
            (AGG.CoordinateMedian(), PART_K)]


@contextlib.contextmanager
def round_snapshots(held):
    """Append to ``held`` a copy of the program's stacked client trees
    (every hospital's) at the start of each participating round, before
    its per-round buffers are loaded: the state the previous round left."""
    import torch

    from repro_torch.core.strategies import engine as ENG
    from repro_torch.tree import tree_map

    orig = ENG._PackedProgram.load_round

    def load_round(self, *args, **kw):
        trees = getattr(self, "all_clients", getattr(self, "clients", None))
        held.append(tree_map(torch.clone, trees))
        orig(self, *args, **kw)
    ENG._PackedProgram.load_round = load_round
    try:
        yield
    finally:
        ENG._PackedProgram.load_round = orig


def part_run(method, adapter, clients, dev, part=None, privacy=None,
             rule=None, rounds=PART_ROUNDS, snapshots=None):
    """``rounds`` rounds of one method on the compiled engine from seed 0
    (``PART_IMAGES`` train images a hospital, the split family over the
    fused int8 link) with ``Strategy.run`` under ``part`` (a
    ``Participation`` or None) and the aggregation ``rule``; returns the
    strategy, state, logs, transport, the replay seconds of each body (the
    first call, with warm-up and capture, apart), wall time and peak.
    ``snapshots`` gets the client trees at each round's start."""
    import numpy as np
    import torch

    from repro_torch import optim as O
    from repro_torch.core.strategies import make_strategy
    from repro_torch.privacy import PrivacyConfig
    from repro_torch.wire import Transport

    split = method != "fl"
    tr = Transport("int8", device=dev) if split else None
    strat = make_strategy(
        method, adapter, lambda: O.adam(1e-4), len(clients), transport=tr,
        privacy=None if privacy is None else PrivacyConfig(**privacy),
        participation=part, aggregator=rule, device=dev)
    state = strat.setup(0)
    data = [{k: v[:PART_IMAGES] for k, v in c.train.items()}
            for c in clients]
    calls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        stack.enter_context(timed_programs(calls))
        if snapshots is not None:
            stack.enter_context(round_snapshots(snapshots))
        t0 = time.perf_counter()
        state, logs = strat.run(state, data, np.random.default_rng(1), BATCH,
                                rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    replays = {}
    for name, t, fresh in calls:
        if not fresh:
            replays.setdefault(name, []).append(t)
    return dict(strat=strat, state=state, logs=logs, tr=tr, wall=wall,
                peak=torch.cuda.max_memory_allocated(), replays=replays,
                first=[(name, round(t, 3)) for name, t, fresh in calls
                       if fresh])


def one_program(label, strat):
    """The run's one program, captured once per body; fails otherwise."""
    progs = list(strat._programs.values())
    if len(progs) != 1 or progs[0].captures != len(progs[0].bodies):
        fail(f"{label}: {len(progs)} programs, "
             f"{progs[0].captures if progs else 0} captures")
    return progs[0]


def mean_s(ts) -> str:
    return f"{sum(ts) / len(ts):.4f}" if ts else "-"


def part_k_equals_n(dev, clients):
    """Phase 12 (a): each method of ``PART_KN`` under ``Participation(k=5)``
    against ``participation=None`` on 5 hospitals, from the same start:
    losses, params and wire bytes equal bit for bit."""
    import torch

    from repro_torch.configs.paper_models import DENSENET121_PAPER
    from repro_torch.core.participation import Participation
    from repro_torch.core.partition import cnn_adapter
    from repro_torch.models.cnn import build_densenet
    from repro_torch.tree import tree_leaves

    adapter = cnn_adapter(build_densenet(DENSENET121_PAPER))
    n = len(clients)
    for method in PART_KN:
        runs = [part_run(method, adapter, clients, dev, part)
                for part in (None, Participation(n_global=n, k=n))]
        a, b = runs
        same_loss = [la.losses == lb.losses and la.client_steps
                     == lb.client_steps for la, lb in zip(a["logs"],
                                                          b["logs"])]
        dp, same = 0.0, True
        for c in range(n):
            for x, y in zip(tree_leaves(a["strat"].params_for_eval(
                    a["state"], c)), tree_leaves(b["strat"].params_for_eval(
                    b["state"], c))):
                same = same and torch.equal(x, y)
                dp = max(dp, float((x - y).abs().max()))
        wire = [r["tr"].bytes_on_wire if r["tr"] else None for r in runs]
        per = without_k9(one_program(
            f"{method} k=N", b["strat"]).per_replay.get("step", {}))
        replay = [mean_s(r["replays"].get("step", [])) for r in (b, a)]
        log(f"  (a) {method}: k=N against none: losses equal "
            f"{all(same_loss)}, params equal {same} (|diff| {dp:.3g}), "
            f"wire {wire[1]} / {wire[0]}; replay s {replay[0]} / "
            f"{replay[1]}; per replay {json.dumps(per)}")
        if not (all(same_loss) and same and wire[0] == wire[1]):
            fail(f"{method}: Participation(k=N) differs from "
                 "participation=None")
        del runs, a, b
        torch.cuda.empty_cache()


def part_k_of_n(dev, clients):
    """Phase 12 (b): the rows of ``PART_KOFN`` on ``PART_N`` hospitals,
    ``Participation(k=PART_K, seed=0)``, ``PART_ROUNDS`` rounds; each
    beside the same program without participation on ``PART_K``
    hospitals (replay seconds and peaks)."""
    import numpy as np
    import torch

    from repro_torch.configs.paper_models import DENSENET121_PAPER
    from repro_torch.core.comm import comm_per_epoch
    from repro_torch.core.participation import Participation
    from repro_torch.core.partition import cnn_adapter
    from repro_torch.models.cnn import build_densenet
    from repro_torch.privacy.accountant import RDPAccountant
    from repro_torch.tree import stack_trees, tree_leaves

    adapter = cnn_adapter(build_densenet(DENSENET121_PAPER))
    part = Participation(n_global=PART_N, k=PART_K, seed=0)
    ids = [set(int(g) for g in part.round_ids(e)) for e in range(PART_ROUNDS)]
    log(f"  sampled hospitals per round: {[sorted(s) for s in ids]}")
    for method, privacy in PART_KOFN:
        label = (f"{method} k={PART_K} of {PART_N} "
                 + "+".join(k for k in ("noise_multiplier", "cut_noise_std")
                            if privacy.get(k)))
        log(f"  (b) {label}:")
        snaps = []
        r = part_run(method, adapter, clients, dev, part, privacy,
                     snapshots=snaps)
        strat, prog = r["strat"], one_program(label, r["strat"])
        per = without_k9(prog.per_replay.get("step", {}))
        sync3 = method.startswith("sflv3")
        dp, cut = privacy.get("noise_multiplier"), privacy.get("cut_noise_std")
        want = {}
        if cut:
            want["cut_noise_roundtrip"] = PART_K if sync3 and dp else 1
        if dp:
            want.update(dp_sqnorms=PART_K if sync3 else 1,
                        dp_scale_accum=PART_K if sync3 else 1)
        if per != want:
            fail(f"{label}: launches per replay {per}, expected {want}")
        # hospitals outside a round: untouched (SFLv2: all take the mean)
        if method != "fl":
            final = stack_trees(r["state"]["clients"])
            ends = snaps[1:] + [final]
            moved = []
            for e, (s0, s1) in enumerate(zip(snaps, ends)):
                for g in range(PART_N):
                    eq = all(torch.equal(x[g], y[g]) for x, y in zip(
                        tree_leaves(s0), tree_leaves(s1)))
                    if not eq:
                        moved.append((e, g))
            if method.startswith("sflv2"):
                rows = tree_leaves(final)
                ok = all(torch.equal(x[g], x[0]) for x in rows
                         for g in range(PART_N))
            else:
                ok = all(g in ids[e] for e, g in moved) and len(moved) == sum(
                    len(s) for s in ids)
            log(f"    hospitals moved per round: {moved}")
            if not ok:
                fail(f"{label}: a hospital outside its round changed (or "
                     "SFLv2's sync did not reach every hospital)")
        # epsilon: the amplified rate q K/N, below the same row at k=N
        eps = [x["epsilon"] for x in strat.privacy_report()]
        if dp:
            # every hospital, sampled or not, composes each round's 2 steps
            q = min(BATCH / PART_IMAGES, 1.0)
            at = {}
            for key, rate in (("K/N", q * part.rate), ("N/N", q)):
                acc = RDPAccountant(privacy["noise_multiplier"],
                                    strat.privacy.delta)
                acc.step(rate, PART_ROUNDS * PART_IMAGES // BATCH)
                at[key] = acc.summary()["epsilon"]
            log(f"    epsilon {eps[0]} per hospital (the accountant at q "
                f"K/N {at['K/N']}, at k=N {at['N/N']})")
            if not (all(e == at["K/N"] for e in eps)
                    and at["K/N"] < at["N/N"]):
                fail(f"{label}: epsilon {eps} is not the accountant's at "
                     f"q K/N ({at['K/N']}) below k=N's ({at['N/N']})")
        if method != "fl":
            example = {k: v[:BATCH] for k, v in clients[0].train.items()}
            comm = comm_per_epoch(method, strat.adapter, example,
                                  [PART_IMAGES] * PART_K, [BATCH] * PART_K,
                                  BATCH, codec=r["tr"].codec)
            legs = PART_ROUNDS * sum(v for k, v in comm.breakdown.items()
                                     if k.startswith("train_"))
            sets = [e.client_set for e in r["tr"].epoch_log]
            log(f"    wire {r['tr'].bytes_on_wire} bytes (sampled "
                f"hospitals' train legs {legs}), client sets {sets}")
            if r["tr"].bytes_on_wire != legs or [set(s) for s in sets] != ids:
                fail(f"{label}: wire bytes or client sets differ from the "
                     "sampled hospitals'")
        if not all(np.isfinite(l.losses).all() for l in r["logs"]):
            fail(f"{label}: non-finite losses")
        evaluate(strat, r["state"], clients)
        base = part_run(method, adapter, clients[:PART_K], dev, None,
                        privacy)
        log(f"    replay s {mean_s(r['replays'].get('step', []))} "
            f"(no participation, {PART_K} hospitals: "
            f"{mean_s(base['replays'].get('step', []))}); round body "
            f"{mean_s(r['replays'].get('round', []))}; first calls "
            f"{r['first']}; peak {r['peak'] / 2**30:.2f} / "
            f"{base['peak'] / 2**30:.2f} GiB; run wall {r['wall']:.3f} / "
            f"{base['wall']:.3f} s; per replay {json.dumps(per)}")
        del r, base, strat, prog, snaps
        torch.cuda.empty_cache()


def host_rule(rule, rows, w, staleness, gids, prev):
    """``rule`` on one leaf in float64 on the host: ``rows`` [S, ...],
    ``w``/``staleness``/``gids`` [S], ``prev`` the pre-round leaf."""
    import numpy as np

    valid = w > 0
    if not valid.any():
        return prev
    name = rule.name
    if name == "staleness_discounted":
        w = w * rule.decay ** staleness
        name = "weighted_mean"
    if name == "weighted_mean":
        return np.tensordot(w, rows, 1) / w.sum()
    if name == "hierarchical":
        reg = np.asarray(rule.regions)[np.maximum(gids, 0)]
        means = [np.tensordot(w[reg == r], rows[reg == r], 1)
                 / w[reg == r].sum() for r in np.unique(reg[valid])]
        return np.mean(means, axis=0)
    x = np.sort(rows[valid], axis=0)
    if name == "coordinate_median":
        return np.median(x, axis=0)
    n = len(x)
    k = min(int(np.floor(rule.trim * n)), max((n - 1) // 2, 0))
    return x[k:n - k].mean(axis=0)


def part_rules(dev, clients):
    """Phase 12 (c): FL over ``PART_N`` hospitals, ``RULE_ROUNDS`` rounds,
    under each rule of ``rules()`` with its count sampled a round; then
    the captured round body replayed once more on the program's own
    stacked locals and per-round buffers, held within ``RULE_BAR`` of
    ``host_rule`` in float64 on the same tensors, and timed."""
    import numpy as np
    import torch

    from repro_torch.configs.paper_models import DENSENET121_PAPER
    from repro_torch.core.participation import Participation
    from repro_torch.core.partition import cnn_adapter
    from repro_torch.models.cnn import build_densenet
    from repro_torch.tree import tree_leaves

    adapter = cnn_adapter(build_densenet(DENSENET121_PAPER))
    for rule, k in rules():
        part = Participation(n_global=PART_N, k=k, seed=0)
        label = f"fl {rule.name} k={k}"
        r = part_run("fl", adapter, clients, dev, part, rule=rule,
                     rounds=RULE_ROUNDS)
        prog = one_program(label, r["strat"])
        round_ms = cuda_ms(lambda: prog("round"), iters=5, warmup=1)
        prev = [x.clone() for x in tree_leaves(prog.glob)]
        prog("round")
        torch.cuda.synchronize()
        w = prog.agg_w.double().cpu().numpy()
        st = prog.staleness.double().cpu().numpy()
        gids = prog.slot_gid.cpu().numpy()
        worst = 0.0
        for rows, out, p in zip(tree_leaves(prog.locals),
                                tree_leaves(prog.glob), prev):
            rows64 = rows.double().cpu().numpy()
            want = host_rule(rule, rows64, w, st, gids,
                             p.double().cpu().numpy())
            scale = max(float(np.abs(rows64).max()), 1e-30)
            worst = max(worst, float(np.abs(out.double().cpu().numpy()
                                            - want).max()) / scale)
        log(f"  (c) {label}: round body {round_ms:.3f} ms a replay "
            f"(CUDA events), step replay s "
            f"{mean_s(r['replays'].get('step', []))}; captured round "
            f"against float64: {worst:.3g} of the rows' scale "
            f"(bar {RULE_BAR}) over {int((w > 0).sum())} rows of weight; "
            f"staleness {st.tolist()}, slot ids "
            f"{gids.tolist()}; first calls {r['first']}")
        if worst > RULE_BAR or not all(np.isfinite(l.losses).all()
                                       for l in r["logs"]):
            fail(f"{label}: the captured round is off its float64 "
                 f"host version by {worst:.3g} (bar {RULE_BAR})")
        evaluate(r["strat"], r["state"], clients)
        del r, prog
        torch.cuda.empty_cache()


def participation_path(dev, clients):
    """Phase 12: participation and the aggregation rules on DenseNet-121
    at 224^2 under cuDNN's deterministic algorithms: (a) k=N against no
    participation on the main path's 5 hospitals, (b) K of N and (c) the
    rules on ``PART_N`` synthetic hospitals.  Returns the launches of
    K3-K6 in the phase."""
    import torch

    from repro_torch.data.synthetic import make_cxr_clients

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        reset_launches()
        part_k_equals_n(dev, clients)
        t0 = time.perf_counter()
        many = make_cxr_clients(seed=1, n_clients=PART_N,
                                train_per_client=PART_IMAGES,
                                val_per_client=BATCH, test_per_client=BATCH,
                                image_size=224)
        log(f"  data: {PART_N} hospitals x {PART_IMAGES} train images at "
            f"224^2 ({time.perf_counter() - t0:.1f} s)")
        part_k_of_n(dev, many)
        part_rules(dev, many)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    launches = {k: v.launches for k, v in path_kernels().items()
                if k in ("K3", "K4", "K5", "K6")}
    log(f"  launches in phase 12: {json.dumps(launches)}")
    if not all(launches.values()):
        fail(f"a kernel of the participation path never launched: "
             f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 13: after training — the schedule, the wire simulator, export,
# checkpoints and the screening service
# ---------------------------------------------------------------------------

SCHED_METHODS = ("sflv3_ac", "sl_am")
SCHED_EPOCHS = 2
# benchmarks/wire_sweep.py's hospitals and batch (the paper's five sites)
SWEEP_TRAIN = [472, 236, 110, 472, 236]
SWEEP_VAL = [118, 59, 28, 118, 59]
SWEEP_BATCH = 32
SCORE_NS = (1, 3, 16, 17, 64, 100)
SERVE_BARS = {"fp32": 1e-5, "bf16": 0.05}
SERVICE_REQUESTS, SERVICE_THREADS = 256, 8


def schedule_opt(hist):
    """``adam(cosine_warmup(1e-4, 2, 6), weight_decay=1e-4)`` whose rate
    also lands in ``hist[step - 1]`` (a device write, so a captured step
    records each replay's own rate)."""
    from repro_torch import optim as O

    sched = O.cosine_warmup(1e-4, 2, 6)

    def lr(step):
        v = sched(step)
        hist.index_copy_(0, (step - 1).reshape(1), v.reshape(1))
        return v
    return sched, lambda: O.adam(lr, weight_decay=1e-4)


def schedule_pair(method, adapter, clients, dev):
    """Part (a): one method on both engines from the same start, 2 epochs
    under the schedule; every loss and param equal, the rates the
    schedule's at each step and not all one.  Returns the two runs, their
    graphs and held buffers dropped."""
    import numpy as np
    import torch

    from repro_torch.tree import tree_leaves

    runs, hists = {}, {}
    for engine in ("stepwise", "compiled"):
        hists[engine] = torch.full((64,), float("nan"), device=dev)
        sched, factory = schedule_opt(hists[engine])
        runs[engine] = engine_run(engine, method, False, adapter, clients,
                                  BATCH, dev, "fp32", epochs=SCHED_EPOCHS,
                                  opt_factory=factory)
    sw, cp = runs["stepwise"], runs["compiled"]
    steps = sum(l.steps for l in cp["logs"])
    want = torch.stack([sched(torch.tensor(k, device=dev))
                        for k in range(1, steps + 1)])
    rates = hists["compiled"][:steps]
    same = all(torch.equal(a, b) for c in range(len(clients))
               for a, b in zip(tree_leaves(sw["strat"].params_for_eval(
                   sw["state"], c)), tree_leaves(cp["strat"].params_for_eval(
                       cp["state"], c))))
    log(f"  {method} under the schedule, {steps} steps: replay seconds "
        f"{[round(x, 4) for x in cp['step_s']]} (stepwise steps "
        f"{[round(x, 4) for x in sw['step_s']]}); rates per step "
        f"{rates.tolist()}")
    if not (same and [l.losses for l in sw["logs"]]
            == [l.losses for l in cp["logs"]]):
        fail(f"{method}: the engines disagree under the schedule")
    if not (torch.equal(rates, want) and torch.equal(
            hists["stepwise"][:steps], want)
            and len(set(rates.tolist())) > 1):
        fail(f"{method}: the rates read {rates.tolist()}, the schedule's "
             f"are {want.tolist()}: frozen at capture, or another step's")
    if not all(np.isfinite(l.losses).all() for l in cp["logs"]):
        fail(f"{method}: non-finite losses under the schedule")
    for run in runs.values():
        run["strat"]._programs.clear()
        run["held"].clear()
    torch.cuda.empty_cache()
    return runs


def simulator_checks(runs, adapter, clients):
    """Part (b): the trained transports through ``timeline_from_
    accounting``, equal across the engines and, for one epoch, to
    ``simulate``; wire_sweep's two gates at full width; each method's
    simulated epoch over the three scenarios and its straggler
    sensitivity."""
    from repro_torch.core.comm import client_batch_counts, comm_per_epoch
    from repro_torch.core.strategies import METHODS
    from repro_torch.wire import (SCENARIOS, Transport, simulate,
                                  straggler_sensitivity,
                                  timeline_from_accounting)

    n_val = [len(c.val["label"]) for c in clients]
    n_train = [2 * BATCH] * len(clients)
    example = {k: v[:BATCH] for k, v in clients[0].train.items()}
    for method, pair in runs.items():
        tls = {}
        for engine, run in pair.items():
            tr = run["tr"]
            if len(tr.epoch_log) != SCHED_EPOCHS:
                fail(f"{method} {engine}: {len(tr.epoch_log)} epochs "
                     "recorded")
            tls[engine] = timeline_from_accounting(tr, n_val, BATCH,
                                                   "hospital_wan")
        one = Transport(pair["compiled"]["tr"].codec, device="cpu")
        one.epoch_log.append(pair["compiled"]["tr"].epoch_log[0])
        first = timeline_from_accounting(one, n_val, BATCH, "hospital_wan")
        sim = simulate(method, adapter, example, n_train, n_val, BATCH,
                       one.codec, "hospital_wan")
        sw, cp = tls["stepwise"], tls["compiled"]
        log(f"  {method} timeline ({SCHED_EPOCHS} epochs, int8, "
            f"hospital_wan): {cp.wall_clock_s:.6f} s, "
            f"{cp.bytes_on_wire:.0f} bytes; one epoch {first.wall_clock_s:.6f}"
            f" s, simulate {sim.wall_clock_s:.6f} s")
        if not (sw.wall_clock_s == cp.wall_clock_s
                and sw.breakdown == cp.breakdown):
            fail(f"{method}: the engines' timelines differ")
        if not (first.wall_clock_s == sim.wall_clock_s
                and first.breakdown == sim.breakdown
                and cp.bytes_on_wire == SCHED_EPOCHS * sim.bytes_on_wire):
            fail(f"{method}: the trained timeline disagrees with simulate")
    sweep = {k: v[:SWEEP_BATCH] for k, v in clients[0].train.items()}
    if len(sweep["label"]) != SWEEP_BATCH:
        fail(f"the sweep's example needs {SWEEP_BATCH} images a hospital")
    for method in METHODS:
        analytic = comm_per_epoch(method, adapter, sweep, SWEEP_TRAIN,
                                  SWEEP_VAL, SWEEP_BATCH).bytes_per_epoch
        got = simulate(method, adapter, sweep, SWEEP_TRAIN, SWEEP_VAL,
                       SWEEP_BATCH, "identity", "lan",
                       keep_events=False).bytes_on_wire
        if abs(got - analytic) > 0.01 * max(analytic, 1.0):
            fail(f"{method}: simulated bytes {got} vs comm_per_epoch "
                 f"{analytic} differ by more than 1%")
        secs = {net: simulate(method, adapter, sweep, SWEEP_TRAIN,
                              SWEEP_VAL, SWEEP_BATCH, "int8", net,
                              keep_events=False).wall_clock_s
                for net in SCENARIOS}
        sens = {net: straggler_sensitivity(method, adapter, sweep,
                                           SWEEP_TRAIN, SWEEP_VAL,
                                           SWEEP_BATCH, "int8", net)
                for net in SCENARIOS}
        log(f"    {method}: identity bytes {got:.0f} = comm_per_epoch; int8 "
            f"epoch seconds {json.dumps(secs)}; straggler sensitivity "
            f"{json.dumps(sens)}")
    tr_counts, _ = client_batch_counts(SWEEP_TRAIN, SWEEP_VAL, SWEEP_BATCH)
    for method in ("sl_ac", "sl_am", "sflv2_ac", "sflv3_ac"):
        kind, _, schedule = method.partition("_")
        tp = Transport("identity", device="cpu")
        tp.record_epoch(adapter, sweep, kind, schedule, tr_counts)
        for nb in tr_counts:
            tp.account(adapter, sweep, count=nb)
        acc = timeline_from_accounting(tp, SWEEP_VAL, SWEEP_BATCH, "lan",
                                       keep_events=False)
        sim = simulate(method, adapter, sweep, SWEEP_TRAIN, SWEEP_VAL,
                       SWEEP_BATCH, "identity", "lan", keep_events=False)
        if (acc.wall_clock_s != sim.wall_clock_s
                or acc.breakdown != sim.breakdown):
            fail(f"{method}: the accounting-fed timeline diverges from "
                 "simulate")
    log("  wire_sweep's gates hold at full width: identity bytes within 1% "
        "of comm_per_epoch for every method, accounting-fed timelines equal "
        "to simulate")


def plain_error(x) -> dict:
    """``Codec.error`` of the int8 link with K2(K1(x)) replaced by the
    plain versions (``act_compress/ref.py``)."""
    import torch

    from repro_torch.kernels.act_compress import ref as R

    r = R.roundtrip_ref(x.reshape(-1, x.shape[-1])).reshape(x.shape).float()
    x = x.float()
    diff = torch.abs(x - r)
    denom = torch.clamp_min(torch.linalg.vector_norm(x.reshape(-1)), 1e-12)
    return {"max_abs": float(diff.max()), "mae": float(diff.mean()),
            "rel_l2": float(torch.linalg.vector_norm(diff.reshape(-1))
                            / denom)}


def boundary_checks(strat, state, clients, dev):
    """Part (c): ``boundary_error`` of the int8 link on hospital 0's
    trained SFLv3 params and one batch of 16: K1 and K2 launch, and every
    value equals the plain versions' on the same activations."""
    import torch

    from repro_torch.tree import tree_leaves
    from repro_torch.wire import Transport, boundary_error

    kernels = path_kernels()
    params = strat.params_for_eval(state, 0)
    batch = strat.to_device({k: v[:BATCH] for k, v in clients[0].test.items()})
    before = {n: kernels[n].launches for n in ("K1", "K2")}
    errs = boundary_error(Transport("int8", device=dev), strat.adapter,
                          params, batch)
    counts = {n: kernels[n].launches - before[n] for n in before}
    with torch.no_grad():
        h = strat.adapter.apply_seg("front", params["front"],
                                    strat.adapter.inputs(batch), batch,
                                    False)
    want = {"front->": [plain_error(l) for l in tree_leaves(h)]}
    log(f"  boundary_error (int8, trained SFLv3, hospital 0, {BATCH} "
        f"images): {json.dumps(errs)}; launches {json.dumps(counts)}")
    if not all(counts.values()):
        fail(f"boundary_error launched no K1 or K2: {counts}")
    if errs != want:
        fail(f"boundary_error {errs} differs from the plain versions' "
             f"{want}")
    return counts


def export_checks(strat, state, clients, dev, tmp):
    """Part (d): export hospital 0 through ``save_servable`` and
    ``load_servable``, its scores against ``Strategy.scores``, and the
    whole state through ``checkpoint``; all bit-equal.  Returns the
    export."""
    import numpy as np
    import torch

    from repro_torch.serving import load_servable, save_servable
    from repro_torch.train import checkpoint

    def equal(a, b):
        fa, fb = dict(checkpoint.tree_paths(a)), dict(checkpoint.tree_paths(b))
        return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k])
                                              for k in fa)

    sv = strat.export(state, 0, meta={"epochs": SCHED_EPOCHS})
    path = str(Path(tmp) / "sflv3_h0.msgpack")
    t0 = time.perf_counter()
    save_servable(path, sv)
    back = load_servable(path, strat.adapter, device=dev)
    t1 = time.perf_counter()
    checkpoint.save(str(Path(tmp) / "state.ckpt"), state)
    whole = checkpoint.load(str(Path(tmp) / "state.ckpt"), state)
    t2 = time.perf_counter()
    data = clients[0].test
    same_scores = np.array_equal(sv.scores(data),
                                 strat.scores(state, 0, data))
    log(f"  export: {Path(path).stat().st_size} bytes, save + load "
        f"{t1 - t0:.3f} s; whole-state checkpoint "
        f"{Path(tmp, 'state.ckpt').stat().st_size} bytes, {t2 - t1:.3f} s; "
        f"scores == Strategy.scores: {same_scores}")
    if not (equal(back.params, sv.params) and back.meta == sv.meta):
        fail("the export does not come back bit-equal from its file")
    if not same_scores or not np.array_equal(back.scores(data),
                                             sv.scores(data)):
        fail("the export's scores differ from Strategy.scores")
    if not equal(whole, state):
        fail("the checkpoint does not come back bit-equal")
    return sv


def scorer_checks(sv, images, dev):
    """Part (e): ``BucketScorer`` in f32 and bf16: one capture per bucket,
    none while scoring ``SCORE_NS`` images, scores within ``SERVE_BARS``
    of ``ServableModel.scores`` (``Strategy.scores``' function), and each
    bucket's replay time."""
    import numpy as np
    import torch

    from repro_torch.serving import BucketScorer

    ref = sv.scores({"image": images})
    for precision, bar in SERVE_BARS.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc = BucketScorer(sv, image_shape=images.shape[1:],
                          precision=precision)
        torch.cuda.synchronize()
        built, t_build = sc.n_compiles, time.perf_counter() - t0
        worst = 0.0
        for n in SCORE_NS:
            got, info = sc.score({"image": images[:n]})
            if got.shape != (n,) or not np.isfinite(got).all():
                fail(f"{precision}: {n} images scored as {got.shape}")
            worst = max(worst, float(np.abs(got - ref[:n]).max()))
        times = {}
        for b, prog in sc._progs.items():
            ms = cuda_ms(lambda prog=prog: prog("score"))
            times[b] = (round(ms, 4), round(b / ms * 1e3, 1))
        log(f"  BucketScorer {precision}: {built} captures in "
            f"{t_build:.2f} s, {sc.n_compiles} after scoring "
            f"{list(SCORE_NS)}; max |score - eval| {worst:.3g} (bar {bar}); "
            f"bucket: (replay ms, images/s) {json.dumps(times)}")
        if built != len(sc.buckets) or sc.n_compiles != built:
            fail(f"{precision}: {built} captures for {len(sc.buckets)} "
                 f"buckets, {sc.n_compiles} after scoring")
        if worst > bar:
            fail(f"{precision}: scores {worst} from Strategy.scores")
        del sc
        torch.cuda.empty_cache()
    return ref


def service_checks(sv, other, images, ref):
    """Part (f): ``ScreeningService``: 256 single-image requests from 8
    threads with one swap to ``other`` (the same network from another
    seed) in the middle; each score within
    the f32 bar of exactly one version's, the versions served never going
    back; ``Backpressure`` past ``max_queue``; latency and throughput."""
    import concurrent.futures as cf

    import numpy as np
    import torch

    from repro_torch.serving import Backpressure, ScreeningService

    ref_other = other.scores({"image": images})
    if not (np.abs(ref - ref_other) > 2 * SERVE_BARS["fp32"]).all():
        fail("the two versions' scores are too close to tell apart")
    n = len(images)
    with ScreeningService(sv, image_shape=images.shape[1:]) as svc:
        def one(i):
            if i == SERVICE_REQUESTS // 2:
                svc.swap(other)
            return svc.score_one({"image": images[i % n]})

        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(SERVICE_THREADS) as ex:
            got = list(ex.map(one, range(SERVICE_REQUESTS)))
        wall = time.perf_counter() - t0
        stats = svc.stats()
        served = [d["version"] for d in svc.batcher._completed]
    got = np.asarray(got, np.float32)
    idx = np.arange(SERVICE_REQUESTS) % n
    near0 = np.abs(got - ref[idx]) <= SERVE_BARS["fp32"]
    near1 = np.abs(got - ref_other[idx]) <= SERVE_BARS["fp32"]
    log(f"  ScreeningService: {SERVICE_REQUESTS} requests from "
        f"{SERVICE_THREADS} threads in {wall:.3f} s "
        f"({SERVICE_REQUESTS / wall:.1f} requests/s); {json.dumps(stats)}; "
        f"version 0 served {int(near0.sum())}, version 1 {int(near1.sum())}")
    if not (near0 ^ near1).all():
        fail("a served score matches neither version (a torn tree?)")
    if served != sorted(served) or set(served) != {0, 1}:
        fail(f"the versions served went back or one is missing: {served}")
    with ScreeningService(sv, image_shape=images.shape[1:], buckets=(64,),
                          max_wait_s=0.5, max_queue=8) as svc:
        reqs = [svc.submit({"image": images[0]}) for _ in range(8)]
        try:
            svc.submit({"image": images[0]})
            fail("no Backpressure past max_queue")
        except Backpressure:
            pass
        if not all(r.done.wait(30) for r in reqs):
            fail("the queued requests were not served after Backpressure")
    log("  Backpressure past max_queue=8; the queued 8 served in one batch "
        f"of {reqs[0].lat['batch_n']}")
    torch.cuda.empty_cache()


def serving_path(dev, clients):
    """Phase 13 on DenseNet-121 at 224^2, 5 hospitals, batch 16, the fused
    int8 link: (a) SFLv3 and SL-AM under a cosine schedule with decay on
    both engines, (b) the wire simulator on the trained transports, (c)
    ``boundary_error`` through K1 and K2, (d) export and checkpoints, (e)
    the bucket scorer in f32 and bf16, (f) the screening service.
    Returns the launches of K1-K3 in the phase."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs.paper_models import DENSENET121_PAPER
    from repro_torch.core.partition import cnn_adapter
    from repro_torch.models.cnn import build_densenet

    adapter = cnn_adapter(build_densenet(DENSENET121_PAPER))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        reset_launches()
        runs = {m: schedule_pair(m, adapter, clients, dev)
                for m in SCHED_METHODS}
        simulator_checks(runs, adapter, clients)
        cp = runs["sflv3_ac"]["compiled"]
        strat, state = cp["strat"], cp["state"]
        del runs
        boundary_checks(strat, state, clients, dev)
        with tempfile.TemporaryDirectory() as tmp:
            sv = export_checks(strat, state, clients, dev, tmp)
        other = strat.export(strat.setup(1), 0)     # another model
        images = np.concatenate([c.train["image"] for c in clients])[
            :max(SCORE_NS)]
        ref = scorer_checks(sv, images, dev)
        service_checks(sv, other, images, ref)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    launches = {k: v.launches for k, v in path_kernels().items()
                if k in ("K1", "K2", "K3")}
    log(f"  launches in phase 13: {json.dumps(launches)}")
    if not all(launches.values()):
        fail(f"a kernel of phase 13 never launched: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 14: the observed grid — telemetry inside the captured graphs
# ---------------------------------------------------------------------------

OBS_METHODS = ("centralized", "fl", "sl_am", "sflv2_ac", "sflv3_ac",
               "sflv1_ac")
OBS_EPOCHS = 2
OBS_PRIVATE = (("fl", PRIVATE_DP), ("sflv3_ac", PRIVATE_CUT))
OBS_BAR = 1e-4        # compiled against stepwise: the reference's own bar
OBS_CUT_BAR = 1e-4    # cut statistics against the held payload, relative
CUT_KEYS = ("cut_mean", "cut_std", "cut_absmax")
OBS_PART_N, OBS_PART_K = 10, 4
# phase 14 (e): the device lane's ``replay.step`` spans against the
# profiler's kernels: start offsets in ms (median, worst) and the share of
# the spans' length in which a kernel runs
ALIGN_MEDIAN_MS, ALIGN_WORST_MS, ALIGN_BUSY = 0.2, 1.0, 0.95
ALIGN_EPOCHS = 3


def clone_state(state):
    """A deep copy of a strategy state (tensors cloned, anything else
    kept)."""
    import torch

    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, state)


@contextlib.contextmanager
def held_cut_outputs(held):
    """Append to ``held`` the output rows of every K3 and K4 launch made
    while a CUDA graph is being captured: the graph's own buffers, so
    after a run they hold the last replay's cut payload exactly as it
    shipped (K3's, or K4's with the noise)."""
    import torch

    from repro_torch.kernels.cut_fuse import ops

    orig3, orig4 = ops.roundtrip_rows, ops.noise_roundtrip_rows

    def keep3(x):
        out = orig3(x)
        if torch.cuda.is_current_stream_capturing():
            held.append(out)
        return out

    def keep4(x, z, w):
        out = orig4(x, z, w)
        if torch.cuda.is_current_stream_capturing():
            held.append(out)
        return out
    ops.roundtrip_rows, ops.noise_roundtrip_rows = keep3, keep4
    try:
        yield
    finally:
        ops.roundtrip_rows, ops.noise_roundtrip_rows = orig3, orig4


def held_moments(held, hospitals, per_hospital):
    """Per-hospital (mean, std, absmax) in float64 of the held payload of
    one step: with ``per_hospital`` the i-th held tensor is hospital i's
    (a private SFLv3 step launches K4 once per hospital), else each held
    tensor (one per boundary leaf) holds every hospital's rows, split into
    ``hospitals`` equal blocks (the batch axis leads the rows)."""
    sums = [[0.0, 0.0, 0, 0.0] for _ in range(hospitals)]
    for i, out in enumerate(held):
        blocks = [out] if per_hospital else out.chunk(hospitals)
        for j, b in enumerate(blocks):
            j = i if per_hospital else j
            x = b.double()
            sums[j][0] += float(x.sum())
            sums[j][1] += float(x.square().sum())
            sums[j][2] += x.numel()
            sums[j][3] = max(sums[j][3], float(x.abs().max()))
    out = []
    for s, sq, n, amax in sums:
        mean = s / n
        out.append((mean, math.sqrt(max(sq / n - mean * mean, 0.0)), amax))
    return out


def cut_stats_on_payload(label, prog, held, hospitals, per_hospital):
    """Fail unless the observed program's last step's cut statistics
    (its metric buffers at the last row) are the moments of the payload
    the captured K3/K4 launches shipped at that step (``held``)."""
    row = prog.n_steps - 1
    want = held_moments(held, hospitals, per_hospital)
    got = [[float(prog.metrics[k][row].reshape(-1)[j]) for k in CUT_KEYS]
           for j in range(hospitals)]
    err = max(abs(g - w) / max(abs(w), 1e-3) for gs, ws in zip(got, want)
              for g, w in zip(gs, ws))
    log(f"    cut statistics of the last replay against the {len(held)} "
        f"held K3/K4 outputs: largest relative difference {err:.3g}")
    if not err <= OBS_CUT_BAR:
        fail(f"{label}: the cut statistics {got} are not the moments of "
             f"the shipped payload {want}")


def obs_run(strat, start, data, batch, epochs, observe, held=None):
    """One ``Strategy.run`` of ``epochs`` from a copy of ``start`` (the
    privacy step counter and accountants reset, so a second run draws the
    first's noise), replays timed; returns the state, logs, the program
    it ran, the replay seconds of the step body and the peak memory."""
    import numpy as np
    import torch

    strat._key_step, strat._accountants = 0, None
    calls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        stack.enter_context(timed_programs(calls))
        if held is not None:
            stack.enter_context(held_cut_outputs(held))
        state, logs = strat.run(clone_state(start), data,
                                np.random.default_rng(1), batch, epochs,
                                observe=observe)
        torch.cuda.synchronize()
    prog = strat._last_run["program"]
    return dict(state=state, logs=logs, prog=prog,
                step_s=[t for name, t, fresh in calls
                        if name == "step" and not fresh],
                peak=torch.cuda.max_memory_allocated())


def params_equal(strat, a, b, n) -> bool:
    import torch

    from repro_torch.tree import tree_leaves
    return all(torch.equal(x, y) for c in range(n) for x, y in zip(
        tree_leaves(strat.params_for_eval(a, c)),
        tree_leaves(strat.params_for_eval(b, c))))


def check_rounds(label, method, rt, n, epochs, dp):
    """The family's key set, rows of ``n`` hospitals (centralized 1), all
    finite, ``update_cosine`` in [-1, 1], ``clip_frac`` in [0, 1]."""
    import numpy as np

    keys = {"loss", "grad_norm", "update_norm"}
    if method == "fl":
        keys.add("update_cosine")
    if method not in ("centralized", "fl"):
        keys.update(CUT_KEYS)
    if dp:
        keys.add("clip_frac")
    rows = 1 if method == "centralized" else n
    if rt is None or len(rt.rounds) != epochs:
        fail(f"{label}: no telemetry, or not one round per epoch")
    for r in rt.rounds:
        if set(r.metrics) != keys:
            fail(f"{label}: keys {sorted(r.metrics)}, expected "
                 f"{sorted(keys)}")
        for k, v in r.metrics.items():
            v = np.asarray(v)
            if v.shape != (rows,) or not np.isfinite(v).all():
                fail(f"{label}: {k} = {v}, expected {rows} finite values")
        if "update_cosine" in keys and (
                np.abs(r.metrics["update_cosine"]) > 1 + 1e-6).any():
            fail(f"{label}: update cosine outside [-1, 1]")
        if dp and not ((r.metrics["clip_frac"] >= 0)
                       & (r.metrics["clip_frac"] <= 1)).all():
            fail(f"{label}: clip fraction outside [0, 1]")


def engines_agree(label, rc, rs, exact=()):
    """Compiled against stepwise telemetry: within ``OBS_BAR``, the keys
    of ``exact`` equal; returns the largest difference."""
    import numpy as np

    worst = 0.0
    for a, b in zip(rc.rounds, rs.rounds):
        if set(a.metrics) != set(b.metrics):
            fail(f"{label}: the engines report different taps")
        for k in a.metrics:
            d = float(np.abs(np.asarray(a.metrics[k])
                             - np.asarray(b.metrics[k])).max())
            worst = max(worst, d)
            if k in exact and d:
                fail(f"{label}: {k} differs between the engines: "
                     f"{a.metrics[k]} / {b.metrics[k]}")
            if not d <= OBS_BAR:
                fail(f"{label}: {k} differs between the engines by {d:.3g}")
        if (a.epsilon is None) != (b.epsilon is None) or (
                a.epsilon is not None
                and not np.array_equal(a.epsilon, b.epsilon)):
            fail(f"{label}: the epsilon series differ between the engines")
    return worst


def observed_pair(method, adapter, clients, batch, dev, privacy=None,
                  precision="fp32", epochs=OBS_EPOCHS, stepwise=True,
                  host=None):
    """Phase 14's check of one method: ``run()``, ``run(observe=
    Telemetry())`` and ``run()`` again from the same start on the same
    compiled strategy (split family over the fused int8 link), then
    (``stepwise``) the stepwise engine observed from the same start.
    Fails unless params are bit-equal, the observed program has its own
    graphs, captured once per body, and the unobserved one is replayed,
    never recaptured, with the same replays per body and hand-kernel
    launches per replay, the telemetry has the family's taps, the cut
    statistics are the moments of the payload K3/K4 shipped, and the
    engines agree.  ``host(strat, run, telemetry)`` is called right after
    the observed run, its tracer attached (phase 14 (e)).  Returns the
    row's printed numbers."""
    import numpy as np
    import torch

    from repro_torch import optim as O
    from repro_torch.core.strategies import make_strategy
    from repro_torch.obs import Telemetry, Tracer
    from repro_torch.privacy import PrivacyConfig
    from repro_torch.tree import tree_leaves
    from repro_torch.wire import Transport

    split = method not in ("centralized", "fl")
    sync = method.startswith(("sflv3", "sflv1"))
    dp = privacy is not None and "clip_norm" in privacy
    n = len(clients)
    label = (f"{method} {precision}" + (" private" if privacy else ""))

    def build(engine):
        return make_strategy(
            method, adapter, lambda: O.adam(1e-4), n,
            transport=Transport("int8", device=dev) if split else None,
            privacy=None if privacy is None else PrivacyConfig(**privacy),
            engine=engine, precision=precision, device=dev)
    strat = build("compiled")
    start = strat.setup(0)
    data = [{k: v[:2 * batch] for k, v in c.train.items()} for c in clients]
    off = obs_run(strat, start, data, batch, epochs, False)
    p = off["prog"]
    graphs = dict(p.graphs)
    if host is not None:
        strat.attach_tracer(Tracer())
    held = []
    on = obs_run(strat, start, data, batch, epochs, Telemetry(), held)
    q, rt = on["prog"], strat.last_run_telemetry
    calls = dict(q.calls)
    if split:
        # before any other replay: the held outputs are the graph's own
        # buffers, in the pool the unobserved program's graphs share
        cut_stats_on_payload(label, q, held, n if sync else 1,
                             sync and dp)
    del held
    if host is not None:
        host(strat, on, rt)
        strat.attach_tracer(None)
    # the unobserved program once more: replayed, not recaptured
    again = obs_run(strat, start, data, batch, epochs, False)
    same = params_equal(strat, off["state"], on["state"], n)
    mean_off = sum(off["step_s"] + again["step_s"]) / (
        len(off["step_s"]) + len(again["step_s"]))
    mean_on = sum(on["step_s"]) / len(on["step_s"])
    log(f"  {label}: replay seconds unobserved {mean_off:.4f} (runs 1 and "
        f"3), observed {mean_on:.4f} (run 2; overhead "
        f"{100 * (mean_on / mean_off - 1):+.2f}%); replays "
        f"{json.dumps(calls)}; per replay {json.dumps(q.per_replay)}; peak "
        f"{off['peak'] / 2**30:.2f} / {on['peak'] / 2**30:.2f} / "
        f"{again['peak'] / 2**30:.2f} GiB; params bit-equal {same}")
    if p is q or len(strat._programs) != 2 or again["prog"] is not p:
        fail(f"{label}: the observed run did not get its own program")
    if p.graphs != graphs:
        fail(f"{label}: observing recaptured the unobserved program")
    if not same or not params_equal(strat, off["state"], again["state"],
                                    n):
        fail(f"{label}: observed params differ from unobserved ones")
    twice = {k: 2 * v for k, v in calls.items()}
    if p.calls != twice or p.per_replay != q.per_replay:
        fail(f"{label}: replays {p.calls} over two runs / {calls} or "
             f"launches per replay {p.per_replay} / {q.per_replay} differ")
    if q.captures != len(q.bodies) or p.captures != len(p.bodies):
        fail(f"{label}: {q.captures} captures of {len(q.bodies)} bodies")
    check_rounds(label, method, rt, n, epochs, dp)
    if [l.telemetry for l in on["logs"]] != rt.rounds:
        fail(f"{label}: EpochLog.telemetry is not the run's rounds")
    if split and privacy is None:
        example = {k: v[:batch] for k, v in clients[0].train.items()}
        leaves = sum(len(tree_leaves(t)) for t in
                     strat.adapter.boundary_specs(example).values())
        per = without_k9(q.per_replay.get("step", {}))
        if per != {"cut_roundtrip": leaves}:
            fail(f"{label}: launches per replay {per}, expected K3 once "
                 f"per boundary leaf ({leaves})")
    worst = None
    if stepwise:
        sw = build("stepwise")
        sw.run(clone_state(start), data, np.random.default_rng(1), batch,
               epochs, observe=Telemetry())
        worst = engines_agree(label, rt, sw.last_run_telemetry,
                              ("clip_frac",))
        log(f"    stepwise engine observed: largest difference {worst:.3g}")
        del sw
    if dp:
        eps = rt.rounds[-1].epsilon
        report = [r["epsilon"] for r in strat.privacy_report()]
        fracs = [r.scalars()["clip_frac"] for r in rt.rounds]
        log(f"    clip fraction {fracs}; epsilon {eps.tolist()}")
        if eps is None or eps.tolist() != report:
            fail(f"{label}: the last epsilon row {eps} is not "
                 f"privacy_report()'s {report}")
    del strat, off, on, again
    torch.cuda.empty_cache()
    return dict(label=label, unobserved_s=mean_off, observed_s=mean_on,
                worst=worst)


def observed_participation(dev, adapter):
    """Phase 14 (c): FL under ``Participation(n_global=10, k=4, seed=0)``,
    2 rounds, observed: each round's ``participation`` the sampled ids,
    the unsampled columns NaN and the sampled ones finite; the split
    family refuses ``observe`` with participation."""
    import numpy as np

    from repro_torch import optim as O
    from repro_torch.core.participation import Participation
    from repro_torch.core.strategies import make_strategy
    from repro_torch.data.synthetic import make_cxr_clients
    from repro_torch.obs import Telemetry

    many = make_cxr_clients(seed=1, n_clients=OBS_PART_N,
                            train_per_client=BATCH, val_per_client=2,
                            test_per_client=2, image_size=224)
    part = Participation(n_global=OBS_PART_N, k=OBS_PART_K, seed=0)
    strat = make_strategy("fl", adapter, lambda: O.adam(1e-4), OBS_PART_N,
                          participation=part, observe=Telemetry(),
                          device=dev)
    strat.run(strat.setup(0), [c.train for c in many],
              np.random.default_rng(1), BATCH, 2)
    rt = strat.last_run_telemetry
    for e, r in enumerate(rt.rounds):
        ids = part.round_ids(e).tolist()
        log(f"  fl K-of-N round {e}: participation {r.participation.tolist()}"
            f", loss {np.round(r.metrics['loss'], 4).tolist()}")
        if r.participation.tolist() != ids:
            fail(f"fl K-of-N: round {e} reports {r.participation}, sampled "
                 f"{ids}")
        for k, v in r.metrics.items():
            out = [c for c in range(OBS_PART_N) if c not in ids]
            if not (np.isnan(v[out]).all() and np.isfinite(v[ids]).all()):
                fail(f"fl K-of-N: {k} = {v}: unsampled columns must be NaN, "
                     "sampled ones finite")
    try:
        make_strategy("sl_am", adapter, lambda: O.adam(1e-4), OBS_PART_N,
                      participation=part, observe=True, device=dev)
    except ValueError as e:
        log(f"  sl_am K-of-N observed: ValueError ({e})")
    else:
        fail("the split family accepted observe with participation")


def observed_host_side(strat, on, rt, clients, tmp):
    """Phase 14 (e): the attached tracer's spans, ``round_events`` and the
    simulated wire lane written as one Chrome trace and read back,
    ``write_runlog``/``write_report``, ``torch_profile`` around one
    observed replay (its trace must name K3's kernel), and ``graph_cost``
    / ``cost_summary`` of the last run."""
    import os
    import re

    from repro_torch.obs import (cost_summary, graph_cost, round_events,
                                 torch_profile, wire_events,
                                 write_chrome_trace, write_report,
                                 write_runlog)
    from repro_torch.wire.simulator import timeline_from_accounting

    tracer = strat._tracer
    spans = [e["name"] for e in tracer.events]
    # the capturing call of each body is not stamped
    stamped = {k: n - 1 for k, n in on["prog"].calls.items() if n > 1}
    lane = {}
    for name in spans:
        if name.startswith("replay."):
            lane[name[7:]] = lane.get(name[7:], 0) + 1
    events = tracer.trace_events() + round_events(rt, tracer.find(
        "dispatch"))
    sim = timeline_from_accounting(strat.transport,
                                   n_val=[len(c.val["label"])
                                          for c in clients],
                                   batch_size=BATCH)
    events += wire_events(sim, label=strat.name)
    path = write_chrome_trace(events, os.path.join(tmp, "trace.json"))
    back = json.load(open(path))["traceEvents"]
    names = {e["name"] for e in back} | {
        e["args"]["name"] for e in back if e["name"] == "thread_name"}
    log(f"  trace: spans {spans}; {len(back)} events written and read "
        f"back")
    host = [n for n in spans if not n.startswith("replay.")]
    if host != ["pack"] + ["h2d"] * OBS_EPOCHS + ["dispatch", "run"] or \
            lane != stamped or len(back) != len(events) or \
            not {"round 0", "round 1", "device (CUDA events)"} <= names:
        fail(f"the observed run's trace lacks its spans, replays ({lane} "
             f"of {stamped}) or round slices")
    cost = cost_summary(strat, wall_seconds=1.0,
                        total_steps=sum(l.steps for l in on["logs"]))
    runlog = write_runlog(tmp, strat.name, telemetry=rt, cost=cost)
    report = write_report(tmp, strat.name, rt, cost=cost)
    if len(json.load(open(runlog))["telemetry"]["rounds"]) != len(
            rt.rounds) or "| round |" not in open(report).read():
        fail("the run log or report lacks the run's rounds")
    prog = on["prog"]
    graph = graph_cost(strat)
    log(f"  graph_cost {json.dumps(graph)}")
    log(f"  cost_summary keys {sorted(cost)}")
    if graph is None or graph["replays"] != prog.calls or \
            graph["launches_per_replay"] != prog.per_replay:
        fail("graph_cost does not describe the last run's program")
    with torch_profile(os.path.join(tmp, "profile")) as prof:
        prog.t.zero_()
        prog("step")
    kernels = {e.get("name", "") for e in json.load(
        open(prof.trace_path))["traceEvents"] if e.get("cat") == "kernel"}
    k3 = sorted(k for k in kernels
                if re.search(r"(?<!noise_)roundtrip(_vec)?_kernel", k))
    log(f"  torch_profile of one observed replay: {len(kernels)} kernels, "
        f"K3 as {k3[:2]}")
    if not k3:
        fail("the profiled observed replay does not name K3's kernel")
    replay_alignment(strat, on["state"], clients)


def replay_alignment(strat, state, clients):
    """Phase 14 (e): ``ALIGN_EPOCHS`` observed epochs from a copy of
    ``state`` under ``torch.profiler``; the tracer's ``replay.step`` spans
    are mapped onto the profiler's clock through one marked range whose
    host time is known (as ``perfbench/trace.py`` maps them) and held
    against the kernels the profiler saw inside them."""
    import statistics

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.obs import Telemetry

    tracer = strat._tracer
    data = [{k: v[:2 * BATCH] for k, v in c.train.items()} for c in clients]
    n0 = len(tracer.events)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mark_host = time.perf_counter()
        with record_function("align.mark"):
            pass
        strat.run(clone_state(state), data, np.random.default_rng(2), BATCH,
                  ALIGN_EPOCHS, observe=Telemetry())
        torch.cuda.synchronize()
    epoch0 = time.perf_counter() - tracer.now()
    kernels, mark = [], None
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        if e.name() == "align.mark":
            if e.device_type() != DeviceType.CUDA:
                mark = a
        elif e.device_type() == DeviceType.CUDA:
            kernels.append((a, a + e.duration_ns() / 1e3))
    off = mark - mark_host * 1e6
    steps = [(epoch0 * 1e6 + e["ts"] + off,
              epoch0 * 1e6 + e["ts"] + e["dur"] + off)
             for e in tracer.events[n0:] if e["name"] == "replay.step"]
    starts, ends, busy = [], [], 0.0
    for a, b in steps:
        over = sorted((s, t) for s, t in kernels if s < b and t > a)
        if not over:
            fail(f"no kernel inside a replay.step span ({a:.1f}, {b:.1f})")
        starts.append(abs(over[0][0] - a) / 1e3)
        ends.append(abs(max(t for _, t in over) - b) / 1e3)
        at = a                    # the union of the kernels, cut to the span
        for s, t in over:
            busy += max(min(t, b) - max(s, at), 0.0)
            at = max(at, t)
    share = busy / sum(b - a for a, b in steps)
    med, worst = statistics.median(starts), max(starts)
    log(f"  device lane against the profiler, {len(steps)} replay.step "
        f"spans of {ALIGN_EPOCHS} epochs (mean "
        f"{sum(b - a for a, b in steps) / len(steps) / 1e3:.3f} ms): start "
        f"offset median {med:.4f} ms, worst {worst:.4f} ms; end offset "
        f"median {statistics.median(ends):.4f} ms, worst {max(ends):.4f} "
        f"ms; kernels busy {100 * share:.2f}% of the spans")
    if len(steps) != 2 * ALIGN_EPOCHS or not (
            med <= ALIGN_MEDIAN_MS and worst <= ALIGN_WORST_MS
            and ALIGN_BUSY <= share <= 1.0):
        fail("the device lane's replay.step spans do not match the "
             "profiler's kernels")


def observed_path(dev, clients):
    """Phase 14: ``observe=`` at full width, DenseNet-121 at 224^2, the
    main path's 5 hospitals, batch 16, the fused int8 link, the compiled
    engine, cuDNN's deterministic algorithms: (a) every method of the grid
    observed against unobserved (``observed_pair``), (b) FL with DP-SGD
    and SFLv3-AC with DP-SGD and cut noise, (c) participation, (d) the
    U-Net at 768^2 in bf16, (e) the host side.  Returns the launches of
    K3-K6 in the phase."""
    import tempfile

    import torch

    from repro_torch.configs.paper_models import DENSENET121_PAPER, UNET_PAPER
    from repro_torch.core.partition import cnn_adapter
    from repro_torch.data.synthetic import make_cxr_clients
    from repro_torch.models.cnn import build_densenet, build_unet

    adapter = cnn_adapter(build_densenet(DENSENET121_PAPER))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rows = []
    try:
        reset_launches()
        log(" (a) every method, observed against unobserved")
        with tempfile.TemporaryDirectory() as tmp:
            def host(strat, on, rt):
                log(" (e) host side, on the observed SFLv3-AC run")
                observed_host_side(strat, on, rt, clients, tmp)
            for method in OBS_METHODS:
                rows.append(observed_pair(
                    method, adapter, clients, BATCH, dev,
                    host=host if method == "sflv3_ac" else None))
        log(" (b) privately")
        for method, privacy in OBS_PRIVATE:
            rows.append(observed_pair(method, adapter, clients, BATCH, dev,
                                      privacy=privacy))
        log(" (c) participation")
        observed_participation(dev, adapter)
        torch.cuda.empty_cache()
        log(f" (d) the U-Net at {UNET_SIZE}^2, bf16")
        unet_clients = make_cxr_clients(
            seed=0, n_clients=5, train_per_client=2 * UNET_BATCH,
            val_per_client=UNET_BATCH, test_per_client=UNET_BATCH,
            image_size=UNET_SIZE)
        rows.append(observed_pair(
            "sflv3_ac", cnn_adapter(build_unet(UNET_PAPER)), unet_clients,
            UNET_BATCH, dev, precision="bf16", epochs=1, stepwise=False))
        del unet_clients
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log("  replay overhead of the taps: " + ", ".join(
        f"{r['label']} {100 * (r['observed_s'] / r['unobserved_s'] - 1):+.2f}%"
        for r in rows))
    launches = {k: v.launches for k, v in path_kernels().items()
                if k in ("K3", "K4", "K5", "K6")}
    log(f"  launches in phase 14: {json.dumps(launches)}")
    if not all(launches.values()):
        fail(f"a kernel of the observed path never launched: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phases 4 and 7: the LM serving slice
# ---------------------------------------------------------------------------

def lm_kernels():
    from repro_torch.kernels.cut_fuse import cut_fuse as CF
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.ssd_scan import ssd_scan as SS
    return {"K3": CF.ROUNDTRIP, "K7": FA.FLASH, "K8": SS.SSD_CHUNK}


def lm_tokens(vocab, seq, device):
    """LM_BATCH prompts of ``seq`` tokens, one from each of LM_BATCH
    synthetic clients (``lm_clients``, seed 0)."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import lm_clients
    return torch.from_numpy(np.concatenate(
        lm_clients(0, vocab, LM_BATCH, 1, seq))).to(device)


def small_generation(model, params, device):
    """8 greedy tokens after LM_BATCH prompts of 16 in f32 on ``device``
    (on the card each a replay of the model's captured decode step, on
    the CPU its body run eagerly): (tokens on the CPU, the device's decode
    program)."""
    import torch

    from repro_torch.serving.engine import decode_programs, greedy_generate
    from repro_torch.tree import tree_map
    p = tree_map(lambda t: t.to(device), params)
    prompt = lm_tokens(model.cfg.vocab_size, 16, device)
    gen = greedy_generate(model, p, prompt, max_new=8, max_len=24,
                          cache_dtype=torch.float32)
    (prog,) = [q for q in decode_programs(model)
               if q.device.type == torch_type(device)]
    return gen.cpu(), prog


def graph_line(prog) -> str:
    return (f"{prog.captures} capture, {prog.calls.get('step', 0)} replays"
            f" of its step")


def lm_small_against_cpu(dev):
    """SmolLM's and Mamba2's SMOKE configs in f32, on the card (K7, K8) and
    on the CPU (their plain versions) from the same params: the scoring
    logits within 5e-5 of their largest magnitude and the losses within
    1e-5 (the CPU tests hold 1e-5 between XLA and ATen on one CPU; cuBLAS
    sums in other tile orders), and equal greedy tokens, the card's from
    the captured decode step (one capture, 7 replays); then the same
    greedy tokens of the decode step's other kinds (``GEN_SMALL``: the
    Zamba2 hybrid's shared-block caches, Kimi-K2's MoE, InternVL2's
    frontend model on text)."""
    import dataclasses

    import torch

    from repro_torch.configs import mamba2_130m, smollm_135m
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.tree import tree_map

    kernels = lm_kernels()
    for cfg in (smollm_135m.SMOKE, mamba2_130m.SMOKE):
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
        model = TransformerLM.build(cfg)
        params = model.init_params(torch.Generator().manual_seed(0), "cpu")
        out = {}
        for device in ("cpu", dev):
            p = tree_map(lambda t: t.to(device), params)
            toks = lm_tokens(cfg.vocab_size, 65, device)
            before = {k: v.launches for k, v in kernels.items()}
            logits, _, _ = model.apply(p, toks[:, :-1], use_pallas=True)
            loss = float(model.loss(p, {"tokens": toks}, train=False,
                                    use_pallas=True))
            gen, prog = small_generation(model, params, device)
            out[torch_type(device)] = (logits.cpu(), loss, gen, {
                k: v.launches - before[k] for k, v in kernels.items()}, prog)
        (lc, fc, gc, _, _), (lg, fg, gg, n, prog) = out["cpu"], out["cuda"]
        dl = max_err(lg, lc)
        scale = float(lc.abs().max())
        log(f"  {cfg.name} f32 at {LM_BATCH} x 64: |logits card - cpu| {dl:.3g} "
            f"(bar {5e-5 * scale:.3g}), losses {fg:.7f} / {fc:.7f}, greedy "
            f"tokens equal {torch.equal(gg, gc)} (card: {graph_line(prog)}), "
            f"launches on the card {n}")
        if not (dl <= 5e-5 * scale and abs(fg - fc) <= 1e-5
                and torch.equal(gg, gc) and prog.captures == 1
                and prog.calls == {"step": 7}):
            fail(f"the card's {cfg.name} disagrees with the CPU's")
    for arch in GEN_SMALL:
        cfg = dataclasses.replace(REGISTRY[arch].smoke,
                                  compute_dtype=torch.float32)
        model = TransformerLM.build(cfg)
        params = model.init_params(torch.Generator().manual_seed(0), "cpu")
        gc, _ = small_generation(model, params, torch.device("cpu"))
        gg, prog = small_generation(model, params, dev)
        log(f"  {cfg.name} f32: greedy tokens card (captured step: "
            f"{graph_line(prog)}) equal to the CPU's {torch.equal(gg, gc)}")
        if not (torch.equal(gg, gc) and prog.captures == 1
                and prog.calls == {"step": 7}):
            fail(f"the card's {cfg.name} generation disagrees with the CPU's")


def timed(fn):
    """(result, host seconds) of one call between two synchronisations."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# Bars of the whole-model comparison kernel path vs plain path (phase 7),
# by compute dtype: (relative RMS difference of the logits, max |diff| as a
# share of the largest logit, or None: printed, not held).  Only summation
# order differs between the paths, but a random-weight model 24-30 layers
# deep amplifies it, and in bf16 (rounding at every op) Mamba2-130M's
# logits decorrelate at some positions: on the CPU, with no CUDA kernel
# (the kernel path takes the plain chunk function there), Mamba2-130M at
# 2 x 256 tokens differs by a relative RMS of 3e-5 in f32 and 0.043 in bf16
# (max 0.63 of a largest logit of 5.3); on the H100 at 4 x 2048 tokens by
# 9.8e-5 in f32 and 0.084-0.113 in bf16 (max 2.1-2.7 of 6).  So the f32
# comparison is the precise one; in bf16 the logits are held only against
# a gross error (unrelated logits differ by a relative RMS of about 1.4),
# and the bf16 eval losses within 1e-2.
LOGIT_BARS = {"float32": (1e-3, 0.01), "bfloat16": (0.5, None)}


def logits_agree(label, a, b) -> bool:
    """Hold logits ``a`` against ``b`` by the bars of their dtype."""
    import torch
    rel_bar, max_bar = LOGIT_BARS[str(b.dtype)[6:]]
    a, b = a.float(), b.float()
    rel = float((a - b).norm() / b.norm())
    mx, scale = max_err(a, b), float(b.abs().max())
    ok = bool(torch.isfinite(a).all()) and rel <= rel_bar and (
        max_bar is None or mx <= max_bar * scale)
    log(f"    {label}: logits relative RMS diff {rel:.3g} (bar {rel_bar:g}), "
        f"max |diff| {mx:.4g} of a largest {scale:.4g}"
        + ("" if max_bar is None else f" (bar {max_bar:g} of it)")
        + ("" if ok else "  FAILS"))
    return ok


def lm_path(dev, profile):
    """Phase 7: SmolLM-135M (K7) and Mamba2-130M (K8) at their published
    widths, random weights from seed 0.  Scoring in bf16 (the configs'
    compute dtype): LM_BATCH prompts of LM_SEQ tokens through ``apply`` and
    ``loss`` with use_pallas True, then with the int8 cut link (K3 once per
    forward) at ``cut_layer`` 4, each held against the same call with
    use_pallas False: losses within 1e-2, logits by ``LOGIT_BARS``; then
    ``apply`` in f32 compute, kernels against plain by the f32 bars (the
    precise comparison).
    Generation (no kernel): ``generation``, the captured decode step
    against the eager one, and the prefill's logits held to the cacheless
    forward's last position; then Zamba2-7B's generation at published
    width (``zamba_generation``).  Returns the launches of K7 and K8 in
    this phase."""
    import dataclasses

    import torch

    from repro_torch.configs import mamba2_130m, smollm_135m
    from repro_torch.kernels.cut_fuse.ops import roundtrip_boundary
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.engine import make_prefill_step

    kernels = lm_kernels()
    for k in kernels.values():
        k.launches = 0
    for cfg, key in ((smollm_135m.CONFIG, "K7"), (mamba2_130m.CONFIG, "K8")):
        per = cfg.n_layers          # one launch per layer and forward
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = TransformerLM.build(cfg)
        params = model.init_params(torch.Generator().manual_seed(0), dev)
        toks = lm_tokens(cfg.vocab_size, LM_SEQ + 1, dev)
        prompts = toks[:, :LM_SEQ]
        log(f"  {cfg.name}: params and {LM_BATCH} x {LM_SEQ + 1} tokens "
            f"in {time.perf_counter() - t0:.1f} s")

        def call(label, fn, want):
            """One call; its launches must be ``want`` (K3, K7, K8)."""
            before = {k: v.launches for k, v in kernels.items()}
            out, sec = timed(fn)
            n = {k: v.launches - before[k] for k, v in kernels.items()}
            log(f"    {label}: {sec * 1e3:.3f} ms, launches {n}")
            if n != want:
                fail(f"{cfg.name} {label}: launches {n}, expected {want}")
            return out, sec

        none = {"K3": 0, "K7": 0, "K8": 0}
        fwd = {**none, key: per}
        link = {**fwd, "K3": 1}
        res = {}
        for pallas in (True, False):
            want = fwd if pallas else none
            tag = "kernels" if pallas else "plain"
            for rep in (1, 2):      # the second is the steady time
                (logits, _, _), sec = call(
                    f"apply use_pallas={pallas} ({rep})",
                    lambda: model.apply(params, prompts,
                                        use_pallas=pallas), want)
            loss, _ = call(f"loss use_pallas={pallas}", lambda: model.loss(
                params, {"tokens": toks}, train=False, use_pallas=pallas),
                want)
            (llog, _, _), _ = call(
                f"apply over the int8 link, use_pallas={pallas}",
                lambda: model.apply(params, prompts, use_pallas=pallas,
                                    boundary_fn=roundtrip_boundary),
                link if pallas else {**none, "K3": 1})
            lloss, _ = call(f"loss over the int8 link, use_pallas={pallas}",
                            lambda: model.loss(params, {"tokens": toks},
                                               train=False,
                                               use_pallas=pallas,
                                               boundary_fn=roundtrip_boundary),
                            link if pallas else {**none, "K3": 1})
            res[tag] = (logits, float(loss), llog, float(lloss), sec)
            log(f"    scoring {tag}: {sec * 1e3:.3f} ms per forward, "
                f"{LM_BATCH * LM_SEQ / sec:,.0f} tokens/s; eval loss "
                f"{float(loss):.6f}, over the int8 link {float(lloss):.6f}")
        (lk, fk, llk, flk, _), (lp, fp, llp, flp, _) = res["kernels"], \
            res["plain"]
        log(f"    kernels vs plain: loss diff {abs(fk - fp):.3g}, over the "
            f"link {abs(flk - flp):.3g} (bar 1e-2)")
        ok = [logits_agree("kernels vs plain, bf16", lk, lp),
              logits_agree("kernels vs plain over the link, bf16", llk, llp),
              abs(fk - fp) <= 1e-2, abs(flk - flp) <= 1e-2]
        del lk, lp, llk, llp, res
        m32 = TransformerLM.build(dataclasses.replace(
            cfg, compute_dtype=torch.float32))
        (lk, _, _), _ = call("apply in f32, use_pallas=True", lambda: m32.apply(
            params, prompts, use_pallas=True), fwd)
        (lp, _, _), _ = call("apply in f32, use_pallas=False",
                             lambda: m32.apply(params, prompts), none)
        ok.append(logits_agree("kernels vs plain, f32", lk, lp))
        del lk, lp
        if not all(ok):
            fail(f"{cfg.name}: the kernel path disagrees with the plain one")

        prompt = prompts[:, :GEN_PROMPT].contiguous()
        max_len = GEN_PROMPT + GEN_NEW
        generation(model, params, prompt, lambda label, fn: call(
            label, fn, none))
        log(f"    peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            " GiB")
        last, _ = make_prefill_step(model, max_len)(params,
                                                    {"tokens": prompt})
        if not logits_agree("prefill through the cache vs the cacheless "
                            "forward's last position", last,
                            model.apply(params, prompt)[0][:, -1]):
            fail(f"{cfg.name}: prefill disagrees with the full forward")
        if profile:
            profile_call(lambda: model.apply(params, prompts,
                                             use_pallas=True),
                         f"{cfg.name} scoring forward ({LM_BATCH} x "
                         f"{LM_SEQ})", LM_KERNEL_GROUPS)
        del params, toks, prompts
        torch.cuda.empty_cache()
    zamba_generation(dev, kernels)
    launches = {k: kernels[k].launches for k in ("K7", "K8")}
    log(f"  launches in phase 7: {launches}, K3 {kernels['K3'].launches}")
    if not all(launches.values()):
        fail(f"a kernel of the LM path never launched: {launches}")
    return launches


def decode_loop(model, params, prompt, step):
    """Greedy decode of GEN_NEW tokens after ``prompt`` (bf16 cache): the
    prompt pass eagerly into a new cache, then ``step`` (the captured or
    the eager decode step) for each further token.  Returns (tokens, the
    steps' last-position logits stacked)."""
    import torch
    b, s = prompt.shape
    cache = model.cache_init(b, s + GEN_NEW, device=prompt.device)
    with torch.no_grad():
        logits, cache, _ = model.apply(params, prompt, cache=cache)
        tok = logits[:, -1:, :].argmax(dim=-1).to(torch.int32)
        toks, lgs = [tok], []
        for i in range(GEN_NEW - 1):
            lg, cache = step(params, cache, tok, torch.full(
                (b, 1), s + i, dtype=torch.int32, device=prompt.device))
            lgs.append(lg)
            tok = lg.argmax(dim=-1, keepdim=True).to(torch.int32)
            toks.append(tok)
    return torch.cat(toks, dim=1), torch.stack(lgs)


def generation(model, params, prompt, call):
    """Phase 7's generation for one model: GEN_NEW greedy tokens after
    ``prompt`` through the captured decode step (``captured_decode_step``)
    and through the eager ``make_decode_step`` loop, from the same prompt
    pass: tokens equal, each step's logits bit-equal (else held by
    ``LOGIT_BARS``, the largest difference printed); then timed, both
    with the prefill: ``greedy_generate`` (its program the one captured
    above: same key and params, its cache reset) against the eager loop,
    new tokens/s each.  One program, one capture.  ``call(label, fn)``
    times a call and checks it launched no hand kernel."""
    import torch

    from repro_torch.serving.engine import (captured_decode_step,
                                            decode_programs, greedy_generate,
                                            make_decode_step,
                                            make_prefill_step)
    name, cfg = model.cfg.name, model.cfg
    b, s = prompt.shape
    graph, lg_graph = decode_loop(model, params, prompt,
                                  captured_decode_step(model))
    eager, lg_eager = decode_loop(model, params, prompt,
                                  make_decode_step(model))
    diff = max_err(lg_graph, lg_eager)
    same = torch.equal(graph, eager)
    log(f"    captured step against eager, {b} x {s} + {GEN_NEW}: tokens "
        f"equal {same}, step logits "
        + ("bit-equal" if diff == 0 else f"differ by up to {diff:.4g}"))
    ok = same and (diff == 0 or logits_agree(
        "captured vs eager step logits", lg_graph, lg_eager))
    del lg_graph, lg_eager
    _, psec = call(f"prefill {b} x {s}", lambda: make_prefill_step(
        model, s + GEN_NEW)(params, {"tokens": prompt}))
    out, sec = call(f"greedy_generate {b} x {s} + {GEN_NEW} (captured step)",
                    lambda: greedy_generate(model, params, prompt, GEN_NEW,
                                            s + GEN_NEW))
    (_, esec) = call(f"eager make_decode_step loop {b} x {s} + {GEN_NEW}",
                     lambda: decode_loop(model, params, prompt,
                                         make_decode_step(model)))
    progs = decode_programs(model)
    n = GEN_NEW - 1
    tok_ms, eager_ms = ((t - psec) / n * 1e3 for t in (sec, esec))
    log(f"    generation: {b * GEN_NEW / sec:,.1f} new tokens/s with the "
        f"captured step ({sec:.3f} s with the prefill), "
        f"{b * GEN_NEW / esec:,.1f} eager ({esec:.3f} s); a token "
        f"{tok_ms:.3f} ms against {eager_ms:.3f} ms past the prefill's "
        f"{psec * 1e3:.3f} ms; programs {len(progs)}: "
        + "; ".join(f"{graph_line(p)}, capture "
                    f"{p.capture_s.get('step', 0):.3f} s" for p in progs))
    if len(progs) == 1:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        for _ in range(n):
            progs[0]("step")
        end.record()
        torch.cuda.synchronize()
        log(f"    one replay of the step: {start.elapsed_time(end) / n:.3f} "
            f"ms (CUDA events over {n})")
    if not (ok and torch.equal(out, graph)):
        fail(f"{name}: the captured decode step disagrees with the eager "
             "one")
    if len(progs) != 1 or progs[0].captures != 1:
        fail(f"{name}: expected one decode program with one capture")
    if out.shape != (b, GEN_NEW) or out.dtype != torch.int32 or \
            not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        fail(f"{name}: generated tokens malformed")


def zamba_generation(dev, kernels):
    """Phase 7's Zamba2-7B: published width, depth cut 81 -> ZAMBA_DEPTH
    (``hybrid_attn_every`` 6 kept: the shared block applied twice, each
    application on its own cache), random bf16 weights from seed 0; the
    generation of ``generation``."""
    import dataclasses

    import torch

    from repro_torch.configs import zamba2_7b
    from repro_torch.models.transformer import TransformerLM, layer_kinds
    cfg = dataclasses.replace(zamba2_7b.CONFIG, n_layers=ZAMBA_DEPTH)
    torch.cuda.reset_peak_memory_stats()
    model = TransformerLM.build(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), dev)
    prompt = lm_tokens(cfg.vocab_size, GEN_PROMPT, dev)
    shared = layer_kinds(cfg).count("shared")
    log(f"  {cfg.name} at published width (d_model {cfg.d_model}), depth "
        f"cut {zamba2_7b.CONFIG.n_layers} -> {ZAMBA_DEPTH} Mamba2 layers "
        f"(hybrid_attn_every {cfg.hybrid_attn_every}: the shared block "
        f"applied {shared} times, {shared} caches), random weights (bf16 "
        "compute)")
    if shared != 2:
        fail(f"{cfg.name}: the cut model applies the shared block {shared} "
             "times")

    def call(label, fn):
        before = {k: v.launches for k, v in kernels.items()}
        out, sec = timed(fn)
        n = {k: v.launches - before[k] for k, v in kernels.items()}
        log(f"    {label}: {sec * 1e3:.3f} ms, launches {n}")
        if any(n.values()):
            fail(f"{cfg.name} {label}: launched {n}")
        return out, sec
    generation(model, params, prompt, call)
    log(f"    peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")
    del params, prompt
    torch.cuda.empty_cache()


# kernel-name fragments of each share that --profile reports
KERNEL_GROUPS = (
    ("hand kernels K1-K6", ("quantize_kernel", "roundtrip_kernel",
                            "sqnorm_", "scale_accum_kernel")),
    ("convolution", ("conv", "xmma", "implicit_gemm", "wgrad", "dgrad",
                     "fprop", "gemm", "cudnn")),
    ("group norm", ("GroupNorm", "group_norm", "RowwiseMoments",
                    "ComputeInternalGradients", "Compute1dBackward",
                    "ComputeFusedParams")),
    ("cat / copy", ("CatArrayBatchedCopy", "copy", "cat")),
)


# the same for one LM scoring forward (phase 7)
LM_KERNEL_GROUPS = (
    ("hand kernels K3, K7, K8", ("flash_fwd_f32_kernel",
                                 "flash_fwd_bf16_kernel", "ssd_chunk_kernel",
                                 "roundtrip_kernel")),
    ("matmul", ("nvjet", "gemm", "xmma", "cutlass", "splitK")),
    ("softmax / reductions", ("softmax", "reduce", "Reduce", "cumsum",
                              "scan")),
    ("cat / copy", ("CatArrayBatchedCopy", "copy", "cat")),
    ("elementwise", ("elementwise_kernel",)),
)


def profile_step(strat, state, clients, batch, label):
    """Device time of one more epoch of one batch per hospital, after a
    warm one: one step of SFLv3, one step per hospital of SL."""
    import numpy as np

    data = [{k: v[:batch] for k, v in c.train.items()} for c in clients]
    strat.run_epoch(state, data, np.random.default_rng(2), batch)  # warm
    profile_call(lambda: strat.run_epoch(state, data,
                                         np.random.default_rng(3), batch),
                 f"{label} step", KERNEL_GROUPS)


def busy_ms(prof) -> float | None:
    """The time at least one kernel ran, the union of the kernels'
    intervals in the trace (a CUDA graph runs independent branches, such
    as the hospitals of a private step, side by side, so the kernels'
    times can add up to more than the wall time); None if the trace holds
    no intervals."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA)
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) / 1e3


def profile_call(fn, label, kernel_groups):
    """Device time of one call of ``fn``, by kernel and by group, and the
    share of its wall time the device was busy (``busy_ms``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if getattr(e, "device_type", None) == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if not total:
        log("  profile: no device time recorded (not measured)")
        return
    busy = busy_ms(prof)
    log(f"  profile of one {label}: kernels {total:.3f} ms on the "
        f"device, {wall_ms:.3f} ms wall under the profiler, busy "
        + ("not measured" if busy is None else
           f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%)"))
    groups = dict.fromkeys([g for g, _ in kernel_groups] + ["other"], 0.0)
    for e in kernels:
        name = next((g for g, frags in kernel_groups
                     if any(f in e.key for f in frags)), "other")
        groups[name] += e.self_device_time_total / 1e3
    log("    by group: " + ", ".join(
        f"{g} {ms:.3f} ms ({100 * ms / total:.1f}%)"
        for g, ms in groups.items()))
    for e in kernels[:12]:
        ms = e.self_device_time_total / 1e3
        log(f"    {ms:9.3f} ms {100 * ms / total:5.1f}%  x{e.count:<5d} "
            f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# phase 15: LM training and the model kinds
# ---------------------------------------------------------------------------

# (a) SmolLM-135M SplitFedv3 at published widths and depth: 4 hospitals x
# 2 sequences of 2048 + 1 tokens a step, 30 steps of adam under wsd
TRAIN_HOSPITALS, TRAIN_SEQS = 4, 2
TRAIN_STEPS, PLAIN_STEPS = 30, 5
TRAIN_WSD = dict(peak=1e-3, warmup=5, stable=15, decay=10)
TRAIN_ROWS = TRAIN_HOSPITALS * TRAIN_SEQS * LM_SEQ     # 16,384 cut rows
# the first loss: ln 49152 = 10.80 plus about 0.5 from the unit-variance
# logits of the 1/sqrt(d) head
FIRST_LOSS = (10.3, 12.3)
# (b) Llama-4 Scout 17B-16E at published widths, 2 layers cut after the
# first: one hospital of 2 sequences of 2048 + 1 tokens
SCOUT_LAYERS, SCOUT_CUT, SCOUT_SEQS = 2, 1, 2
SCOUT_ROWS = SCOUT_SEQS * LM_SEQ                        # 4,096 cut rows
# the compiled engine under add_noise: chain(clip 1.0, add_noise std, adam)
NOISE_STD, NOISE_SEED = 1e-3, 7
# (c) every registry SMOKE config in f32, card against CPU: one forward and
# one Adam step (eps 1e-3, so the update is Lipschitz in the gradient,
# lr / eps = 1): logits within 5e-5 of their largest magnitude (phase 4's
# bar), losses within 1e-5, params within 1e-5
SMALL_LR, SMALL_EPS = 1e-3, 1e-3
SMALL_PARAM_BAR = 1e-5


def noise_opt():
    from repro_torch import optim as O
    return O.chain(O.clip_by_global_norm(1.0),
                   O.add_noise(NOISE_STD, seed=NOISE_SEED), O.adam(1e-4))


def noise_engine_path(dev, clients):
    """``chain(clip_by_global_norm, add_noise, adam)`` on the compiled
    engine against the stepwise one (``engine_pair``: every loss and
    param bit-equal, one capture per body) on FL (1 round: 10 step
    replays) and SFLv3 (2 epochs: 4) at DenseNet-121 224^2, 2 batches of
    16 an epoch on the main path's 5 hospitals.  A replay that drew the
    noise of the capture again would differ from the stepwise engine's
    fresh draws at the second step.  (The stepwise engine's eager
    Threefry, some 150 small launches a leaf, makes its FL step about
    0.8 s longer; a replay pays none of that host time.)"""
    import torch

    from repro_torch.configs.paper_models import DENSENET121_PAPER
    from repro_torch.core.partition import cnn_adapter
    from repro_torch.models.cnn import build_densenet

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for method, epochs in (("fl", 1), ("sflv3_ac", 2)):
            engine_pair(method, False, "fp32", {
                "opt": noise_opt, "epochs": epochs,
                "opt_label": f"chain(clip, add_noise {NOISE_STD:g}, adam)"},
                cnn_adapter(build_densenet(DENSENET121_PAPER)), clients,
                BATCH, dev)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def lm_link_rows(dev, gen, table):
    """K1, K2 and K3 at the LM training links' rows, bf16: SmolLM-135M's
    16,384 x 576 (phase 15 (a), K1 and K2) and Llama-4 Scout's 4,096 x
    5,120 (phase 15 (b), K1, K2 and K3), each bit-equal to its plain
    version and on the path its design gives (576: the vector path; 5,120
    is wider than a group's vectors hold: the general path), then timed
    as phase 3 times them
    (K2 beside ``torch.mul``); the entries land in the kernels line's rows
    under ``lm_576_bf16`` and ``lm_5120_bf16``."""
    import torch
    from repro_torch.kernels.act_compress import act_compress as AC
    from repro_torch.kernels.act_compress import ref as R
    from repro_torch.kernels.cut_fuse import cut_fuse as CF

    for key, t, d in (("lm_576_bf16", TRAIN_ROWS, 576),
                      ("lm_5120_bf16", SCOUT_ROWS, 5120)):
        x = (torch.randn((t, d), device=dev, generator=gen) * 3).to(
            torch.bfloat16)
        n = x.numel()
        q, s = AC.quantize_rows(x)
        out, lib = (torch.empty_like(x) for _ in range(2))
        paths = {"K1": k1_path(x), "K2": k2_path(q, x.dtype),
                 "K3": k3_path(x)}
        same = {"K1": k1_equals_plain(x, q, s),
                "K2": rows_vs_plain(AC.dequantize_rows(q, s, x.dtype),
                                    lambda q, s: R.dequantize_ref(
                                        q, s, torch.bfloat16), q, s)[0],
                "K3": rows_vs_plain(CF.roundtrip_rows(x), R.roundtrip_ref,
                                    x)[0]}
        # the path the design gives: a row of more vectors than a group
        # of 32 lanes holds (MAX_VECS each) takes the general path
        want = "vector" if AC.vector_plans(d, x.dtype) else "general"
        log(f"  LM link rows {t} x {d} bf16: bit-equal {same}, paths "
            f"{paths} (the design's: {want})")
        if not all(same.values()) or not all(
                p.startswith(want) for p in paths.values()):
            fail(f"the LM link kernels at {t} x {d}: bit-equal {same}, "
                 f"paths {paths}, expected {want}")
        qa, k2a = AC.quantize_args(x, q, s), AC.dequantize_args(q, s, out)
        entries = {"K1": timed_bare(
            "K1 cut_quantize", paths["K1"], lambda: AC.quantize_rows(x),
            lambda: AC.QUANTIZE(*qa), lambda: R.quantize_ref(x),
            bound("K1", t, d, 2 * n, n + 4 * t), t, d, x.dtype),
            "K2": timed_bare(
            "K2 cut_dequantize", paths["K2"],
            lambda: AC.dequantize_rows(q, s, x.dtype),
            lambda: AC.DEQUANTIZE(*k2a),
            lambda: R.dequantize_ref(q, s, torch.bfloat16),
            bound("K2", t, d, n + 4 * t, 2 * n), t, d, x.dtype,
            library=lambda: torch.mul(q, s, out=lib))}
        if d == 5120:
            k3a = CF.roundtrip_args(x, out)
            entries["K3"] = timed_bare(
                "K3 cut_roundtrip", paths["K3"],
                lambda: CF.roundtrip_rows(x), lambda: CF.ROUNDTRIP(*k3a),
                lambda: R.roundtrip_ref(x), bound("K3", t, d, 2 * n, 2 * n),
                t, d, x.dtype)
        for k, entry in entries.items():
            table[k][key] = entry
        del x, q, s, out, lib
        torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_link():
    """``act_compress.ops.compress_boundary`` replaced by the plain
    version of K2(K1) (straight-through all the same) while a train step
    is made: the step then launches no kernel."""
    from repro_torch.kernels import straight_through
    from repro_torch.kernels.act_compress import ops as ACO
    from repro_torch.kernels.act_compress import ref as R

    kept = ACO.compress_boundary
    ACO.compress_boundary = straight_through(R.roundtrip_ref)
    try:
        yield
    finally:
        ACO.compress_boundary = kept


def link_launches():
    from repro_torch.kernels.act_compress import act_compress as AC
    from repro_torch.kernels.cut_fuse import cut_fuse as CF
    return {"K1": AC.QUANTIZE.launches, "K2": AC.DEQUANTIZE.launches,
            "K3": CF.ROUNDTRIP.launches}


def launched_since(before) -> dict:
    return {k: v - before[k] for k, v in link_launches().items()}


def params_diff(a, b) -> float:
    from repro_torch.tree import tree_leaves
    return max(max_err(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


# the same for one LM training step (phase 15 (a))
LM_TRAIN_KERNEL_GROUPS = (
    ("hand kernels K1, K2", ("quantize_vec_kernel", "dequantize_vec_kernel",
                             "quantize_general_kernel",
                             "dequantize_kernel")),
    ("matmul", ("nvjet", "gemm", "xmma", "cutlass", "splitK")),
    ("softmax / reductions", ("softmax", "reduce", "Reduce", "cumsum",
                              "scan", "logsumexp")),
    ("cat / copy", ("CatArrayBatchedCopy", "copy", "cat")),
    ("elementwise", ("elementwise_kernel",)),
)


def smollm_training(dev, profile=False):
    """Phase 15 (a): SmolLM-135M SplitFedv3 at published widths and depth
    (30 layers, cut 4, remat, bf16 compute, f32 masters), 4 hospitals of
    ``lm_clients`` (seed 0), 2 sequences of 2048 + 1 tokens each a step,
    ``make_sflv3_train_step(compress=True)`` under ``adam(wsd)``: one
    joint link call a step, so K1 and K2 launch once a step.  Step 1 is
    also taken over the plain link from the same state: losses within
    1e-2, params within two of step 1's learning rates (one Adam step
    moves a param by about its rate).  Then 5 steps of
    ``make_plain_train_step`` on the whole model.  ``profile`` profiles
    one more SFLv3 step (``profile_call``)."""
    import numpy as np
    import torch

    from repro_torch import optim as O
    from repro_torch.configs import smollm_135m
    from repro_torch.data.synthetic import lm_clients
    from repro_torch.launch.train import (init_sflv3_params,
                                          make_plain_train_step,
                                          make_sflv3_train_step)
    from repro_torch.models.layers import param_count
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.tree import tree_map

    cfg = smollm_135m.CONFIG
    model = TransformerLM.build(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_sflv3_params(model, torch.Generator(device=dev)
                               .manual_seed(0), TRAIN_HOSPITALS, dev)
    data = lm_clients(0, cfg.vocab_size, TRAIN_HOSPITALS, 64, LM_SEQ + 1)
    rng = np.random.default_rng(0)
    log(f"  {cfg.name} SFLv3: {param_count(params):,} params "
        f"({TRAIN_HOSPITALS} fronts and the middle), remat {cfg.remat}, "
        f"compute {str(cfg.compute_dtype)[6:]}; params and data in "
        f"{time.perf_counter() - t0:.1f} s")

    def batch():
        return {"tokens": torch.from_numpy(np.concatenate(
            [d[rng.integers(0, len(d), TRAIN_SEQS)] for d in data])).to(dev)}
    sched = O.wsd(TRAIN_WSD["peak"], TRAIN_WSD["warmup"],
                  TRAIN_WSD["stable"], TRAIN_WSD["decay"])
    opt = O.adam(sched)
    step = make_sflv3_train_step(model, opt, TRAIN_HOSPITALS, compress=True)
    with plain_link():
        plain_step = make_sflv3_train_step(model, opt, TRAIN_HOSPITALS,
                                           compress=True)

    b = batch()
    before = link_launches()
    pp, _, lp = plain_step(params, opt.init(params), b)
    plain_n = launched_since(before)
    state = opt.init(params)
    losses, step_ms, per_step = [], [], []
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for i in range(TRAIN_STEPS):
        if i:
            b = batch()
        before = link_launches()
        e0.record()
        params, state, loss = step(params, state, b)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        per_step.append(launched_since(before))
        losses.append(float(loss))
        if i == 0:
            bar = 2 * float(sched(1))
            dl, dp = abs(losses[0] - float(lp)), params_diff(params, pp)
            log(f"    step 1, kernels vs plain link from the same state: "
                f"loss {losses[0]:.6f} / {float(lp):.6f} (|diff| {dl:.3g}, "
                f"bar 1e-2), |param diff| {dp:.3g} (bar {bar:.3g}); "
                f"launches {per_step[0]} / plain {plain_n}")
            if dl > 1e-2 or dp > bar or any(plain_n.values()):
                fail(f"{cfg.name}: the training link's kernels disagree "
                     "with their plain versions")
            del pp
    want = {"K1": 1, "K2": 1, "K3": 0}
    steady = float(np.median(step_ms[1:]))
    log(f"    losses {[round(x, 4) for x in losses]}")
    log(f"    step ms: first {step_ms[0]:.1f}, median of the rest "
        f"{steady:.1f} (min {min(step_ms[1:]):.1f}, max "
        f"{max(step_ms[1:]):.1f}); {TRAIN_ROWS / steady * 1e3:,.0f} training "
        f"tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches a "
        f"step {per_step[0]} (the design's {want})")
    first5, last5 = np.mean(losses[:5]), np.mean(losses[-5:])
    if not np.isfinite(losses).all():
        fail(f"{cfg.name}: non-finite training losses")
    if not FIRST_LOSS[0] <= losses[0] <= FIRST_LOSS[1]:
        fail(f"{cfg.name}: first loss {losses[0]:.4f} outside {FIRST_LOSS}")
    if not last5 < first5:
        fail(f"{cfg.name}: the loss did not fall ({first5:.4f} -> "
             f"{last5:.4f})")
    if any(n != want for n in per_step):
        fail(f"{cfg.name}: launches a step {per_step}, expected {want}")
    log(f"    mean loss of the first 5 steps {first5:.4f}, of the last 5 "
        f"{last5:.4f}")
    if profile:
        b = batch()
        profile_call(lambda: step(params, state, b),
                     f"{cfg.name} SFLv3 training step ({TRAIN_ROWS} tokens)",
                     LM_TRAIN_KERNEL_GROUPS)

    full = {"front": tree_map(lambda x: x[0].clone(), params["fronts"]),
            "middle": params["middle"]}
    del state
    popt = O.adam(1e-4)
    pstate, pstep = popt.init(full), make_plain_train_step(model, popt)
    pooled = {"tokens": torch.from_numpy(np.concatenate(
        [d[:TRAIN_SEQS] for d in data])).to(dev)}
    plosses, pms = [], []
    for _ in range(PLAIN_STEPS):
        e0.record()
        full, pstate, loss = pstep(full, pstate, pooled)
        e1.record()
        torch.cuda.synchronize()
        pms.append(e0.elapsed_time(e1))
        plosses.append(float(loss))
    log(f"    make_plain_train_step x {PLAIN_STEPS} on "
        f"{TRAIN_HOSPITALS * TRAIN_SEQS} x {LM_SEQ + 1} tokens: losses "
        f"{[round(x, 4) for x in plosses]}, step ms "
        f"{[round(x, 1) for x in pms]}")
    if not np.isfinite(plosses).all():
        fail(f"{cfg.name}: non-finite plain-step losses")
    del params, full, pstate
    torch.cuda.empty_cache()


def scout_path(dev):
    """Phase 15 (b): Llama-4 Scout 17B-16E at published widths (d_model
    5120, 40/8 heads, 16 experts of d_ff 8192, top-1, a shared expert,
    vocab 202,048), depth cut to 2 layers, cut after the first: each
    segment holds one MoE layer.  bf16 compute, f32 params, one hospital
    of 2 sequences of 2048 + 1 tokens.  The scoring ``apply`` over
    ``roundtrip_boundary`` (K3 once a forward) against the same call over
    the plain link, by ``LOGIT_BARS``, in turns (plain, K3, K3, plain; the
    second of each timed); ``loss`` with the MoE aux (finite, aux > 0,
    every layer's ``dropped`` in [0, 1]); then ``loss.backward()`` over
    ``compress_boundary`` twice (K1 and K2 once each; the second timed),
    no optimizer: f32 params
    and gradients take about 52 GB, and Adam's two moments would not fit
    beside them."""
    import dataclasses

    import torch

    from repro_torch.configs import llama4_scout_17b_a16e
    from repro_torch.kernels import straight_through
    from repro_torch.kernels.act_compress import ops as ACO
    from repro_torch.kernels.act_compress import ref as R
    from repro_torch.kernels.cut_fuse.ops import roundtrip_boundary
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import param_count
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(llama4_scout_17b_a16e.CONFIG,
                              n_layers=SCOUT_LAYERS, cut_layer=SCOUT_CUT)
    model = TransformerLM.build(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    toks = lm_tokens(cfg.vocab_size, LM_SEQ + 1, dev)[:SCOUT_SEQS]
    torch.cuda.synchronize()
    log(f"  {cfg.name}, {SCOUT_LAYERS} layers cut at {SCOUT_CUT}: "
        f"{param_count(params):,} params, segments "
        f"{[(s.name, [r.kind for r in s.runs]) for s in model.segments]}; "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    plain = straight_through(R.roundtrip_ref)
    with torch.no_grad():
        secs, counts = {}, {}
        for link, fn in (("plain", plain), ("int8", roundtrip_boundary),
                         ("int8", roundtrip_boundary), ("plain", plain)):
            # in turns; the first of each warms up
            before = link_launches()
            (out, _, aux), sec = timed(lambda: model.apply(
                params, toks[:, :-1], boundary_fn=fn))
            counts.setdefault(link, []).append(launched_since(before))
            secs.setdefault(link, []).append(sec)
            if link == "int8":
                lk = out
            else:
                lp = out
            del out
        sec, psec = secs["int8"][1], secs["plain"][1]
        log(f"    scoring forward over the int8 link: {sec * 1e3:.1f} ms "
            f"({SCOUT_ROWS / sec:,.0f} tokens/s; first call "
            f"{secs['int8'][0] * 1e3:.1f} ms), launches {counts['int8']}; "
            f"over the plain link {psec * 1e3:.1f} ms (first "
            f"{secs['plain'][0] * 1e3:.1f} ms), launches {counts['plain']}")
        ok = logits_agree("K3 link vs plain link, bf16", lk, lp)
        del lk, lp
        if not ok or counts["int8"] != [{"K1": 0, "K2": 0, "K3": 1}] * 2 \
                or any(any(c.values()) for c in counts["plain"]):
            fail(f"{cfg.name}: the scoring link disagrees with its plain "
                 f"version, or launched {counts}")
        dropped, inner = [], MOE.moe_apply

        def recording(p, c, x):
            y, a = inner(p, c, x)
            dropped.append(float(a["dropped"]))
            return y, a
        MOE.moe_apply = recording
        try:
            loss = model.loss(params, {"tokens": toks}, train=False)
        finally:
            MOE.moe_apply = inner
    log(f"    loss {float(loss):.5f} with aux {float(aux):.5f}; dropped "
        f"share per MoE layer {dropped}")
    if not (torch.isfinite(loss) and float(aux) > 0
            and len(dropped) == SCOUT_LAYERS
            and all(0 <= d <= 1 for d in dropped)):
        fail(f"{cfg.name}: loss {float(loss)}, aux {float(aux)}, dropped "
             f"{dropped}")
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)

    def backward():
        for leaf in leaves:
            leaf.grad = None
        loss = model.loss(params, {"tokens": toks}, train=True,
                          boundary_fn=ACO.compress_boundary)
        loss.backward()
        return loss
    ns, secs = [], []
    for _ in range(2):                  # the first warms up
        before = link_launches()
        loss, sec = timed(backward)
        ns.append(launched_since(before))
        secs.append(sec)
    n = ns[1] if ns[0] == ns[1] else ns
    norms = torch._foreach_norm([l.grad for l in leaves])
    finite = bool(torch.isfinite(torch.stack(norms)).all())
    log(f"    loss and backward over the int8 link (remat {cfg.remat}): "
        f"{sec * 1e3:.1f} ms ({SCOUT_ROWS / sec:,.0f} tokens/s; first "
        f"call {secs[0] * 1e3:.1f} ms), loss "
        f"{float(loss.detach()):.5f}, launches {n}, every gradient finite "
        f"{finite}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not finite or n != {"K1": 1, "K2": 1, "K3": 0}:
        fail(f"{cfg.name}: backward launches {n}, gradients finite "
             f"{finite}")
    del params, leaves, loss, norms
    torch.cuda.empty_cache()


def registry_small_against_cpu(dev):
    """Phase 15 (c): every registry SMOKE config in f32, one forward and
    one ``make_plain_train_step`` Adam step on the card against the same
    calls on the CPU from the same params (2 sequences of 33 tokens, and
    the frontend's embeddings where it has one); then every full CONFIG
    through ``param_shapes``: its param count, nothing allocated."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import optim as O
    from repro_torch.configs import registry
    from repro_torch.launch.train import make_plain_train_step, param_shapes
    from repro_torch.models.layers import param_count
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.tree import tree_leaves, tree_map

    for aid, entry in registry.REGISTRY.items():
        cfg = dataclasses.replace(entry.smoke, compute_dtype=torch.float32)
        model = TransformerLM.build(cfg)
        params = model.init_params(torch.Generator().manual_seed(0), "cpu")
        rng = np.random.default_rng(0)
        b = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 33)).astype(np.int32))}
        if cfg.frontend:
            b["frontend_emb"] = torch.from_numpy(rng.normal(size=(
                2, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                    np.float32))
        out = {}
        for device in ("cpu", dev):
            p = tree_map(lambda t: t.to(device), params)
            bd = {k: v.to(device) for k, v in b.items()}
            logits, _, _ = model.apply(p, bd["tokens"][:, :-1],
                                       frontend_emb=bd.get("frontend_emb"))
            opt = O.adam(SMALL_LR, eps=SMALL_EPS)
            p2, _, loss = make_plain_train_step(model, opt)(
                p, opt.init(p), bd)
            out[torch_type(device)] = (logits.cpu(), float(loss),
                                       tree_map(lambda t: t.cpu(), p2))
        (lc, fc, pc), (lg, fg, pg) = out["cpu"], out["cuda"]
        dl, scale, dp = max_err(lg, lc), float(lc.abs().max()), \
            params_diff(pg, pc)
        log(f"  {aid} SMOKE ({cfg.arch_type}) f32: |logits card - cpu| "
            f"{dl:.3g} (bar {5e-5 * scale:.3g}), losses {fg:.7f} / "
            f"{fc:.7f}, |params after one Adam step| {dp:.3g} (bar "
            f"{SMALL_PARAM_BAR:g})")
        if not (dl <= 5e-5 * scale and abs(fg - fc) <= 1e-5
                and dp <= SMALL_PARAM_BAR):
            fail(f"the card's {aid} SMOKE disagrees with the CPU's")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    counts = {}
    for aid, entry in registry.REGISTRY.items():
        shapes = param_shapes(TransformerLM.build(entry.config))
        if not all(l.device.type == "meta" for l in tree_leaves(shapes)):
            fail(f"param_shapes of {aid} allocated a leaf")
        counts[aid] = param_count(shapes)
    log(f"  full CONFIG param counts (param_shapes, meta): "
        f"{json.dumps(counts)}; card memory held before and after "
        f"{held} / {torch.cuda.memory_allocated()} bytes")
    if torch.cuda.memory_allocated() != held:
        fail("param_shapes allocated memory on the card")


def lm_train_path(dev, clients, table, profile=False):
    """Phase 15: LM training and the model kinds.  K1-K3 at the LM links'
    rows (timed; their launches are not counted), then, with the counts
    at 0: the compiled engine under add_noise, (a) SmolLM-135M SFLv3
    training, (b) Llama-4 Scout's MoE layers forward and backward, (c)
    every registry entry small, card against CPU.  Returns the launches
    of K1-K3 in (a), (b) and the add_noise pairs (``profile``: and in
    the profiled step of (a))."""
    import torch

    lm_link_rows(dev, torch.Generator(device=dev).manual_seed(15),
                 table)
    reset_launches()
    noise_engine_path(dev, clients)
    smollm_training(dev, profile)
    scout_path(dev)
    registry_small_against_cpu(dev)
    launches = link_launches()
    log(f"  launches in phase 15: {launches}")
    if not all(launches.values()):
        fail(f"a kernel of the LM training path never launched: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 16: placement over several devices and the launch layer
# ---------------------------------------------------------------------------

# train images per hospital: uneven (2 or 1 batches of 16), so FedAvg's
# weights, the masked steps and SFLv3's wrap-around matter; 5 hospitals on
# 4 devices pad to 8 (3 phantoms)
PLACE_IMAGES = (32, 16, 32, 16, 32)
PLACE_EPOCHS = 2
PLACE_BAR = 1e-5                 # the reference's placement bar
# (label, method, privacy, observe): (b)'s runs, the split family over the
# fused int8 link
PLACE_ROWS = [("fl dp", "fl", PRIVATE_DP, False),
              ("sl_am", "sl_am", None, False),
              ("sflv2_ac", "sflv2_ac", None, False),
              ("sflv3_ac cut noise", "sflv3_ac", dict(cut_noise_std=0.5),
               False),
              ("sflv1_ac", "sflv1_ac", None, False),
              ("sflv3_ac observed", "sflv3_ac", None, True)]


def place_run(method, clients, dev, shard, devices, privacy=None,
              observe=False, start=None):
    """Two epochs of one method on the compiled engine from seed 0 (or
    ``start``), ``shard``ed over ``devices``, then the same two epochs
    again from the same start (captured already: replays and the host's
    copies only), timed with CUDA events and the host clock.  Returns the
    strategy, the first run's state and logs, the transport, the second
    run's device milliseconds and wall seconds, the peak memory of the
    first and the launches of each kernel over both runs."""
    import numpy as np
    import torch

    from repro_torch import optim as O
    from repro_torch.core.strategies import make_strategy
    from repro_torch.privacy import PrivacyConfig
    from repro_torch.tree import tree_map
    from repro_torch.wire import Transport

    tr = Transport("int8", device=dev) if method != "fl" else None
    strat = make_strategy(
        method, small_adapter_full(), lambda: O.adam(1e-4), len(clients),
        transport=tr, privacy=None if privacy is None
        else PrivacyConfig(**privacy), device=dev, shard=shard,
        devices=devices, observe=True if observe else None)
    start = strat.setup(0) if start is None else start
    data = [{k: v[:n] for k, v in c.train.items()}
            for c, n in zip(clients, PLACE_IMAGES)]
    kernels = path_kernels()
    before = {n: k.launches for n, k in kernels.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, logs = strat.run(tree_map(torch.clone, start), data,
                            np.random.default_rng(1), BATCH, PLACE_EPOCHS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    strat.run(tree_map(torch.clone, start), data, np.random.default_rng(1),
              BATCH, PLACE_EPOCHS)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(strat=strat, start=start, state=state, logs=logs, tr=tr,
                ms=e0.elapsed_time(e1), wall=wall, peak=peak,
                launches={n: k.launches - before[n]
                          for n, k in kernels.items()})


_FULL_ADAPTER = []


def small_adapter_full():
    """DenseNet-121 at the paper's cut (LS), built once."""
    if not _FULL_ADAPTER:
        from repro_torch.configs.paper_models import DENSENET121_PAPER
        from repro_torch.core.partition import cnn_adapter
        from repro_torch.models.cnn import build_densenet
        _FULL_ADAPTER.append(cnn_adapter(build_densenet(DENSENET121_PAPER)))
    return _FULL_ADAPTER[0]


def place_compare(label, a, b, clients, bar=PLACE_BAR):
    """``b`` (placed) against ``a`` (unplaced): losses, every hospital's
    params and ``scores_all`` within ``bar``, step counts, epsilon and wire
    bytes exactly; returns whether params and losses were bit-equal."""
    import numpy as np
    import torch

    from repro_torch.tree import tree_leaves

    n = len(clients)
    losses_eq, worst_loss = True, 0.0
    for la, lb in zip(a["logs"], b["logs"]):
        if (la.steps, la.weights, la.client_steps) != (
                lb.steps, lb.weights, lb.client_steps):
            fail(f"{label}: step counts or loss weights differ")
        d = np.abs(np.asarray(la.losses) - np.asarray(lb.losses))
        worst_loss = max(worst_loss, float(d.max()) if d.size else 0.0)
        losses_eq &= la.losses == lb.losses
    params_eq, worst = True, 0.0
    for i in range(n):
        for x, y in zip(tree_leaves(a["strat"].params_for_eval(a["state"], i)),
                        tree_leaves(b["strat"].params_for_eval(b["state"],
                                                               i))):
            y = y.to(x.device)
            params_eq &= torch.equal(x, y)
            worst = max(worst, (x - y).abs().max().item())
    tests = [c.test for c in clients]
    sa = a["strat"].scores_all(a["state"], tests, BATCH)
    sb = b["strat"].scores_all(b["state"], tests, BATCH)
    worst_score = max(float(np.abs(x - y).max()) for x, y in zip(sa, sb))
    eps_a, eps_b = a["strat"].privacy_report(), b["strat"].privacy_report()
    wire = ((a["tr"].steps, a["tr"].bytes_on_wire),
            (b["tr"].steps, b["tr"].bytes_on_wire)) if a["tr"] else None
    log(f"    {label}: params {'bit-equal' if params_eq else 'max |diff| '}"
        f"{'' if params_eq else f'{worst:.3g}'}, losses "
        f"{'bit-equal' if losses_eq else f'max |diff| {worst_loss:.3g}'}, "
        f"scores max |diff| {worst_score:.3g} (bar {bar}); epsilon "
        f"{[round(r['epsilon'], 6) for r in eps_b][:1] or '-'} "
        f"{'equal' if eps_a == eps_b else 'DIFFERENT'}; wire "
        f"{wire[1][1] if wire else '-'} "
        f"{'equal' if not wire or wire[0] == wire[1] else 'DIFFERENT'}")
    if max(worst, worst_loss, worst_score) > bar:
        fail(f"{label}: placed run beyond {bar} of the unplaced one")
    if eps_a != eps_b or (wire and wire[0] != wire[1]):
        fail(f"{label}: epsilon or wire bytes differ when placed")
    return params_eq and losses_eq


def place_chunks(label, strat, devices):
    """Each chunk program on its own device, its buffers there, captured
    once per body it ran (the non-private SFLv3/v1 server too, on the
    first device); returns the captures per chunk (the server's last)."""
    progs = strat._programs
    idx = sorted(key[0][1] for key in progs if key[0][0] != "sync_server")
    if idx != list(range(len(devices))):
        fail(f"{label}: chunk programs {idx} for {len(devices)} devices")
    caps = []
    for key, prog in sorted(progs.items(), key=lambda kv: (
            kv[0][0][0] == "sync_server", kv[0][0][1])):
        server = key[0][0] == "sync_server"
        dev = devices[0 if server else key[0][1]]
        name = "server" if server else f"chunk {key[0][1]}"
        bufs = [*prog.batches.values(), prog.losses, prog.t]
        if prog.device != dev or any(t.device != dev for t in bufs):
            fail(f"{label}: {name} not on {dev}")
        # a chunk of phantoms only has no step of the SL family to run
        want = len(prog.bodies) if prog.calls else 0
        if prog.captures != want:
            fail(f"{label}: {name} captured {prog.captures} times for "
                 f"{len(prog.bodies)} bodies, calls {prog.calls}")
        caps.append(prog.captures)
    return caps


def place_rows(dev, clients, devices, tag):
    """(b)/(c): every row of ``PLACE_ROWS`` placed over ``devices`` against
    the unplaced run from the same start; returns the placed runs'
    launches."""
    launches = {}
    for label, method, privacy, observe in PLACE_ROWS:
        a = place_run(method, clients, dev, False, None, privacy, observe)
        b = place_run(method, clients, dev, True, devices, privacy, observe,
                      start=a["start"])
        place = b["strat"].placement
        if not place.enabled or place.c_pad != 8 and len(devices) == 4:
            fail(f"{tag} {label}: placement {place}")
        bit = place_compare(f"{tag} {label}", a, b, clients)
        caps = place_chunks(f"{tag} {label}", b["strat"], devices)
        if observe:
            ra = a["strat"].last_run_telemetry
            rb = b["strat"].last_run_telemetry
            worst = 0.0
            for x, y in zip(ra.rounds, rb.rounds):
                for k in x.metrics:
                    import numpy as np
                    mx, my = np.asarray(x.metrics[k]), np.asarray(
                        y.metrics[k])
                    if mx.shape != my.shape:
                        fail(f"{tag} {label}: metric {k} shapes "
                             f"{mx.shape} / {my.shape}")
                    if mx.size:
                        worst = max(worst, float(np.nanmax(np.abs(
                            mx - my))))
            log(f"      telemetry: {len(rb.rounds)} rounds, keys "
                f"{sorted(rb.rounds[0].metrics)}, max |diff| {worst:.3g}")
            if worst > PLACE_BAR:
                fail(f"{tag} {label}: telemetry beyond {PLACE_BAR}")
        log(f"      c_pad {place.c_pad} ({place.n_pad} phantoms), captures "
            f"per chunk {caps}; second run (replays and copies): "
            f"{b['ms']:.1f} ms placed / {a['ms']:.1f} ms unplaced (CUDA "
            f"events), wall {b['wall']:.3f} / {a['wall']:.3f} s; peak "
            f"{b['peak'] / 2**30:.2f} / {a['peak'] / 2**30:.2f} GiB; "
            f"launches placed {json.dumps(b['launches'])}"
            f"{' (bit-equal)' if bit else ''}")
        for k, n in b["launches"].items():
            launches[k] = launches.get(k, 0) + n
        del a, b
    return launches


# (d): the dry run's full-width combos, on the host beside (a)-(c)
DRY_ARCHS = ("smollm-135m", "llama4-scout-17b-a16e")
DRY_SCRIPT = """
import json, sys
import torch
sys.path.insert(0, "src")
from repro_torch.launch import dryrun as D
for arch in {archs!r}:
    before = torch.cuda.memory_allocated(0)
    rec = D.run_combo(arch, "train_4k", False)
    if rec["status"] == "ok":
        rec["roofline"] = D.roofline_terms(rec, 256, "h100_sxm")
    rec["cuda_allocated"] = [before, torch.cuda.memory_allocated(0)]
    rec.pop("traceback", None)
    print("DRY " + json.dumps(rec), flush=True)
"""


def start_dry_runs():
    """Phase 16 (d) in a process of its own (its fake process group of 256
    ranks stays out of this one): ``train_4k`` of each ``DRY_ARCHS`` on the
    single production mesh, at full width."""
    return subprocess.Popen(
        [sys.executable, "-c", DRY_SCRIPT.format(archs=DRY_ARCHS)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_dry_runs(proc):
    """Read (d)'s records: each ``ok``, nothing allocated (no op result
    holding memory, the card's allocated bytes unchanged); print the
    per-device costs and the H100 roofline terms."""
    out, err = proc.communicate(timeout=600)
    recs = [json.loads(line[4:]) for line in out.splitlines()
            if line.startswith("DRY ")]
    if proc.returncode or len(recs) != len(DRY_ARCHS):
        fail(f"(d) the dry run exited {proc.returncode}: {err[-2000:]}")
    for rec in recs:
        if rec["status"] != "ok":
            fail(f"(d) {rec['arch']}: {rec.get('error')}")
        before, after = rec["cuda_allocated"]
        roof = rec["roofline"]
        log(f"  (d) dry run {rec['arch']} train_4k on (16, 16): per device "
            f"{rec['hlo_flops']:.4g} FLOP, {rec['hlo_bytes']:.4g} HBM bytes "
            f"(unfused), collectives {json.dumps(rec['collectives'])}; "
            f"params {rec['param_bytes']}, optimizer {rec['opt_bytes']}, "
            f"inputs {rec['input_bytes']}, peak live "
            f"{rec['peak_live_bytes']} bytes; H100 roofline (s): compute "
            f"{roof['t_compute']:.4g}, memory {roof['t_memory']:.4g}, "
            f"collective {roof['t_collective']:.4g} ({roof['dominant']}); "
            f"resharded {json.dumps(rec['resharded'])}; {rec['run_s']} s; "
            f"card allocated bytes {before} -> {after}, results holding "
            f"memory {rec['allocated_results']}")
        if after != before or rec["allocated_results"]:
            fail(f"(d) {rec['arch']}: the dry run allocated memory")


def placement_path(dev, clients):
    """Phase 16, under cuDNN's deterministic algorithms: (a) ``shard=True``
    on one card against ``shard=False``, bit for bit; (b) the placed rows
    over ``[card] * 4`` virtual devices; (c) over the distinct cards when
    there are several; (d) the dry runs, started first in a process of
    their own.  Returns the launches of (b) and (c) (K3-K6 must all
    launch)."""
    import torch

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    dry = start_dry_runs()
    try:
        reset_launches()
        for method in ("fl", "sflv3_ac"):
            a = place_run(method, clients, dev, False, None)
            b = place_run(method, clients, dev, True, [dev],
                          start=a["start"])
            if b["strat"].placement.enabled or b["strat"].placement.padded:
                fail(f"(a) {method}: one card placed "
                     f"{b['strat'].placement}")
            if not place_compare(f"(a) {method} one card", a, b, clients,
                                 0.0):
                fail(f"(a) {method}: shard=True on one card is not "
                     "bit-equal")
        launches = {k: 0 for k in path_kernels()}
        virtual = [dev] * 4
        log(f"  (b) virtual devices {[str(d) for d in virtual]}")
        for k, n in place_rows(dev, clients, virtual, "(b)").items():
            launches[k] += n
        count = torch.cuda.device_count()
        if count >= 2:
            cards = [torch.device("cuda", i) for i in range(min(count, 4))]
            log(f"  (c) real devices {[str(d) for d in cards]}")
            for k, n in place_rows(dev, clients, cards, "(c)").items():
                launches[k] += n
        else:
            log(f"  (c) real devices: not run, this machine has {count} "
                "CUDA device")
        finish_dry_runs(dry)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    log(f"  launches in phase 16: {json.dumps(launches)}")
    if not all(launches[k] for k in ("K3", "K4", "K5", "K6")):
        fail(f"a kernel of the placed path never launched: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 17: the port's reference examples on the card
# ---------------------------------------------------------------------------

EXAMPLES = ("quickstart", "federated_cxr", "compressed_splitfed",
            "private_splitfed", "train_and_serve", "serve_decode")


def example_losses(name, out) -> dict:
    """An example's training runs: {label: per-epoch mean losses}, and
    whether each must fall (the non-private ones)."""
    if name == "quickstart":
        return {m: (out[m]["losses"], True) for m in ("sflv3_ac", "sl_ac")}
    if name == "federated_cxr":
        return {"fl": (out["losses"], True)}
    if name == "compressed_splitfed":
        return {k: (r["losses"], True) for k, r in out["runs"].items()}
    if name == "private_splitfed":
        return {k: (r["losses"], k == "non-private") for k, r in out.items()
                if k != "train_images"}
    if name == "train_and_serve":
        return {"fl": ([r["loss"] for r in out["rounds"]], True)}
    return {}


def examples_path(dev):
    """Phase 17: each of the port's six reference examples
    (``examples/<name>_torch.py``) through its ``main`` on the card at the
    reference's own sizes, its printed results shown (telemetry tables
    left out): every loss finite and the non-private ones falling, the
    assertions of ``train_and_serve`` (served scores within 1e-5 of
    ``scores_all``, the checkpoint round trip bit-exact), and
    ``serve_decode``'s tokens well formed, each model's step captured
    once.  Returns the wall seconds of each example."""
    import contextlib
    import importlib.util
    import io

    import torch

    from repro_torch.configs.registry import REGISTRY
    secs = {}
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"{name}_torch_example", ROOT / "examples" / f"{name}_torch.py")
        mod = importlib.util.module_from_spec(spec)
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            spec.loader.exec_module(mod)
            with contextlib.redirect_stdout(buf):
                out = mod.main([])
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - reported, then fail
            log(buf.getvalue())
            fail(f"example {name}: {type(e).__name__}: {e}")
        secs[name] = time.perf_counter() - t0
        log(f"  examples/{name}_torch.py ({secs[name]:.1f} s):")
        for line in buf.getvalue().splitlines():
            if line.strip() and not line.startswith("|"):
                log(f"    {line}")
        for label, (losses, falls) in example_losses(name, out).items():
            if not all(math.isfinite(l) for l in losses) or (
                    falls and not losses[-1] < losses[0]):
                fail(f"example {name} {label}: losses {losses}")
        if name == "serve_decode":
            for arch, run in out.items():
                t, vocab = run["tokens"], REGISTRY[arch].smoke.vocab_size
                if t.dtype != torch.int32 or t.shape != (4, 24) or \
                        not bool(((t >= 0) & (t < vocab)).all()) or \
                        run["captures"] != 1:
                    fail(f"example serve_decode {arch}: tokens malformed or "
                         f"{run['captures']} captures")
    return secs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3,
                    help="SplitFedv3 steps per main-path run (>= 2)")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if args.steps < 2:
        fail("--steps must be at least 2")

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    dev = torch.device("cuda", 0)

    clock = [time.perf_counter()]

    def phase(title):
        """Print the wall time of the phase that ends, then the title of
        the next (None: the last has ended)."""
        now = time.perf_counter()
        if len(clock) > 1:
            log(f"  ({now - clock[-1]:.1f} s)")
        clock.append(now)
        if title:
            log(title)

    phase("phase 1: card")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase("phase 2: build")
    libs = build.build()
    log(f"  built {[p.name for p in libs]}")

    phase("phase 3: kernels against their plain versions")
    table = check_kernels(dev)
    table.update(check_lm_kernels(dev, torch.Generator(device=dev)
                                  .manual_seed(1)))

    phase("phase 4: the slices at small size, card against CPU")
    small_against_cpu(dev)
    grid_small_against_cpu(dev)
    lm_small_against_cpu(dev)

    phase("phase 5: the main path, DenseNet-121 at 224^2")
    clients = main_data(args.steps)
    launches = main_path(dev, clients, args.profile)

    phase("phase 6: the private main path, DenseNet-121 at 224^2")
    for key, n in private_path(dev, clients, args.profile).items():
        launches[key] = launches.get(key, 0) + n

    phase("phase 7: LM serving, SmolLM-135M and Mamba2-130M, and the "
          f"captured decode step on Zamba2-7B (depth {ZAMBA_DEPTH})")
    launches.update(lm_path(dev, args.profile))

    phase("phase 8: the Table-2 grid, DenseNet-121 at 224^2 and the U-Net "
          f"at {UNET_SIZE}^2")
    for key, n in grid_path(dev, clients, args.profile).items():
        launches[key] += n

    phase("phase 9: the compiled engine against the stepwise one, "
          f"DenseNet-121 at 224^2 and the U-Net at {UNET_SIZE}^2")
    for key, n in compiled_path(dev, clients, args.profile).items():
        launches[key] += n

    phase("phase 11: the private grid, DenseNet-121 at 224^2")
    for key, n in private_grid_path(dev, clients, args.profile).items():
        launches[key] += n

    phase("phase 12: participation and the aggregation rules, "
          "DenseNet-121 at 224^2")
    for key, n in participation_path(dev, clients).items():
        launches[key] += n

    phase("phase 13: after training — schedule, wire simulator, export, "
          "checkpoints, screening service, DenseNet-121 at 224^2")
    for key, n in serving_path(dev, clients).items():
        launches[key] += n

    phase("phase 14: the observed grid — telemetry inside the captured "
          "graphs, DenseNet-121 at 224^2 and the U-Net at "
          f"{UNET_SIZE}^2")
    for key, n in observed_path(dev, clients).items():
        launches[key] += n

    phase("phase 15: LM training and the model kinds — add_noise on the "
          "compiled engine, SmolLM-135M SFLv3, Llama-4 Scout's MoE layers, "
          "the registry")
    for key, n in lm_train_path(dev, clients, table,
                                args.profile).items():
        launches[key] += n

    phase("phase 16: placement over several devices and the launch layer, "
          "DenseNet-121 at 224^2")
    for key, n in placement_path(dev, clients).items():
        launches[key] += n
    del clients

    phase("phase 17: the port's six reference examples at their own sizes")
    examples_path(dev)

    phase("phase 10: the kernels line")
    launches["K9"] = launches.pop("K9 stats") + launches.pop("K9 apply")
    for key, n in launches.items():
        table[key]["launches"] = n
    phase(None)
    log(f"  all phases: {clock[-1] - clock[0]:.1f} s")

    log(card)
    log(json.dumps({"kernels": list(table.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
