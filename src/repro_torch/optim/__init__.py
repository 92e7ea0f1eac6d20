"""Functional optimizers (counterpart of ``repro.optim``)."""

from repro_torch.optim.optimizers import (Optimizer, adam, apply_updates,
                                         tree_gaussian_noise)

__all__ = ["Optimizer", "adam", "apply_updates", "tree_gaussian_noise"]
