"""Plain PyTorch version of the fused cut-layer roundtrip (K3): K2 after
K1, which the fused kernel must equal bit for bit."""

from __future__ import annotations

from repro_torch.kernels.act_compress.ref import roundtrip_ref

__all__ = ["roundtrip_ref"]
