"""repro_torch.privacy — DP-SGD, cut-layer noise and the RDP accountant
(counterpart of ``repro.privacy``).

  * ``dpsgd``      — PrivacyConfig, per-example clip/noise gradients (K5/K6
                     in ``kernels/dp_clip``) and cut-layer activation noise
                     (K4 in ``kernels/cut_fuse`` over the fused int8 link).
  * ``accountant`` — the RDP accountant, a copy of the reference's, giving
                     (eps, delta) PER HOSPITAL.

``leakage`` (the No-Peek probes) and ``secagg`` (FL only) are not ported
yet (ROADMAP M8).  Entry point: ``make_strategy(..., privacy=
PrivacyConfig(...))``.
"""

from repro_torch.privacy.accountant import (DEFAULT_ORDERS, RDPAccountant,
                                            epoch_steps, epsilon, rdp_to_eps,
                                            rdp_sampled_gaussian)
from repro_torch.privacy.dpsgd import (PrivacyConfig, boundary_with_key,
                                       cut_noise_boundary, dp_value_and_grad,
                                       per_example_grads)

__all__ = [
    "PrivacyConfig", "dp_value_and_grad", "per_example_grads",
    "cut_noise_boundary", "boundary_with_key",
    "RDPAccountant", "epsilon", "epoch_steps", "rdp_sampled_gaussian",
    "rdp_to_eps", "DEFAULT_ORDERS",
]
