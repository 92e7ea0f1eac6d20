"""Functional optimizers and LR schedules (counterpart of ``repro.optim``).

``opt = adam(1e-4); state = opt.init(params);
updates, state = opt.update(grads, state, params);
params = apply_updates(params, updates)``.
"""

from repro_torch.optim.optimizers import (Optimizer, adam, add_noise,
                                          apply_updates, chain,
                                          clip_by_global_norm, sgd,
                                          tree_gaussian_noise)
from repro_torch.optim.schedules import constant, cosine_warmup, wsd

__all__ = ["adam", "add_noise", "sgd", "apply_updates",
           "clip_by_global_norm", "chain", "Optimizer",
           "tree_gaussian_noise", "constant", "cosine_warmup", "wsd"]
