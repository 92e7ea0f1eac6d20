"""Plain PyTorch versions of the fused cut-layer kernels: K3 is K2 after K1;
K4 adds the row-weighted noise to that, each product rounded on its own
before the add (the reference's ``pin_product`` order).  The kernels must
equal them bit for bit."""

from __future__ import annotations

from repro_torch.kernels.act_compress.ref import roundtrip_ref


def noise_roundtrip_ref(x, z, w):
    """x: (T, D) f32/bf16, z: f32 (T, D), w: f32 (T, 1) ->
    ``roundtrip(x) + (z * w).to(x.dtype)``."""
    return roundtrip_ref(x) + (z * w).to(x.dtype)


__all__ = ["roundtrip_ref", "noise_roundtrip_ref"]
