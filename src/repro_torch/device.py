"""Where the port runs: the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device, raising when no GPU
    is present; ``"cpu"`` only when asked for by name (tests, small runs)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA GPU and none is available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}")


def use_full_fp32(device: torch.device) -> None:
    """``precision="fp32"`` means full float32 on the card: cuDNN would
    otherwise run f32 convolutions in TF32 (about three decimal digits).
    The flags are process-wide; the CPU has no TF32 and needs nothing."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
