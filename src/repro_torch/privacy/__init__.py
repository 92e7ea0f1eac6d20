"""repro_torch.privacy — DP-SGD, cut-layer noise, the RDP accountant,
secure aggregation and the leakage probes (counterpart of
``repro.privacy``).

  * ``dpsgd``      — PrivacyConfig, per-example clip/noise gradients (K5/K6
                     in ``kernels/dp_clip``) and cut-layer activation noise
                     (K4 in ``kernels/cut_fuse`` over the fused int8 link).
  * ``accountant`` — the RDP accountant, a copy of the reference's, giving
                     (eps, delta) PER HOSPITAL.
  * ``leakage``    — No-Peek cut-layer metrics: distance correlation and
                     linear reconstruction / label probes, on exactly what
                     crosses the transport.
  * ``secagg``     — pairwise-mask secure aggregation for FedAvg, fixed
                     point mod 2^32 with exact mask cancellation and
                     metered mask-exchange bytes.

Entry point: ``make_strategy(..., privacy=PrivacyConfig(...))``.
"""

from repro_torch.privacy.accountant import (DEFAULT_ORDERS, RDPAccountant,
                                            epoch_steps, epsilon, rdp_to_eps,
                                            rdp_sampled_gaussian)
from repro_torch.privacy.dpsgd import (PrivacyConfig, boundary_with_key,
                                       cut_noise_boundary, dp_value_and_grad,
                                       per_example_grads)
from repro_torch.privacy.leakage import (distance_correlation,
                                         label_probe_auc, measure_leakage,
                                         reconstruction_probe,
                                         smashed_activations)
from repro_torch.privacy.secagg import SecAgg

__all__ = [
    "PrivacyConfig", "dp_value_and_grad", "per_example_grads",
    "cut_noise_boundary", "boundary_with_key",
    "RDPAccountant", "epsilon", "epoch_steps", "rdp_sampled_gaussian",
    "rdp_to_eps", "DEFAULT_ORDERS",
    "distance_correlation", "measure_leakage", "reconstruction_probe",
    "label_probe_auc", "smashed_activations",
    "SecAgg",
]
