"""repro_torch — the PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

It grows slice by slice beside the JAX package, which stays the reference.
This package imports ``torch`` and never ``jax`` or ``repro``.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
