"""Computation accounting (paper Tables 5/6): server FLOPs, average client
FLOPs and model-averaging FLOPs per epoch — counterpart of
``repro/core/flops.py``.

Per-segment forward FLOPs are counted by ``torch.utils.flop_counter.
FlopCounterMode`` over one segment application on ``meta`` tensors (no
memory, no compute).  It counts matmuls and convolutions only, where the
reference's XLA ``cost_analysis`` also counts elementwise work, so the two
counts differ by a few percent (the tests state by how much).  Training
FLOPs use the fwd+bwd = 3x forward rule; averaging FLOPs are analytic:
(n_clients adds + 1 scale) per parameter, once per epoch, as the paper
counts them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.partition import META, SplitAdapter, as_meta
from repro_torch.models.layers import param_count

TRAIN_FACTOR = 3.0     # fwd + bwd


@dataclasses.dataclass(frozen=True)
class FlopsProfile:
    method: str
    server_tflops: float
    avg_client_tflops: float
    averaging_mflops: float


def segment_fwd_flops(adapter: SplitAdapter, example_batch: dict) -> dict:
    """Forward FLOPs per segment, per batch."""
    params = adapter.init(None, META)
    b = {k: as_meta(v) for k, v in example_batch.items()}
    out = {}
    x = adapter.inputs(b)
    with torch.no_grad():
        for seg in adapter.seg_names:
            with FlopCounterMode(display=False) as fc:
                x = adapter.apply_seg(seg, params[seg], x, b, True)
            out[seg] = float(fc.get_total_flops())
    return out


def flops_per_epoch(method: str, adapter: SplitAdapter, example_batch: dict,
                    n_train: list[int], batch_size: int,
                    seg_fwd: dict | None = None) -> FlopsProfile:
    n_clients = len(n_train)
    total_batches = sum(n // batch_size for n in n_train)

    if seg_fwd is None:
        seg_fwd = segment_fwd_flops(adapter, example_batch)
    client_fwd = seg_fwd["front"] + seg_fwd.get("tail", 0.0)
    server_fwd = seg_fwd["middle"]
    full_fwd = sum(seg_fwd.values())

    params = adapter.init(None, META)
    p_all = param_count(params)
    p_client = param_count(params["front"]) + param_count(
        params.get("tail", {}))
    p_middle = param_count(params["middle"])

    if method == "centralized":
        return FlopsProfile(method,
                            TRAIN_FACTOR * full_fwd * total_batches / 1e12,
                            0.0, 0.0)
    if method == "fl":
        avg_client = TRAIN_FACTOR * full_fwd * total_batches / n_clients
        averaging = p_all * (n_clients + 1)
        return FlopsProfile(method, 0.0, avg_client / 1e12, averaging / 1e6)

    server = TRAIN_FACTOR * server_fwd * total_batches
    avg_client = TRAIN_FACTOR * client_fwd * total_batches / n_clients
    averaging = 0.0
    if method.startswith("sflv2"):
        averaging = p_client * (n_clients + 1)
    elif method.startswith("sflv3"):
        averaging = p_middle * (n_clients + 1)
    elif method.startswith("sflv1"):
        averaging = p_all * (n_clients + 1)
    return FlopsProfile(method, server / 1e12, avg_client / 1e12,
                        averaging / 1e6)
