"""Per-epoch communication accounting (paper Table 4) — counterpart of
``repro/core/comm.py``, sized from ``meta`` tensors instead of
``jax.eval_shape``.

One epoch = training over all train batches + validation over all val
batches.  Per train batch the cut-layer traffic is:
  LS : activations up + activation-gradients down           (front<->middle)
  NLS: + hidden down + hidden-gradients up                  (middle<->tail)
Validation moves activations only.  Breakdown keys name the transfer's
physical direction (client->server = up).  FL moves 2 x model bytes per
client per round; SFLv2/v1 also ship the client segment(s) both ways for
averaging.  A ``codec`` shrinks the activation legs only.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.partition import META, SplitAdapter, leaf_bytes
from repro_torch.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class CommProfile:
    method: str
    bytes_per_epoch: float
    breakdown: dict

    @property
    def gb(self):
        return self.bytes_per_epoch / 1e9


def client_batch_counts(n_train: list[int], n_val: list[int],
                        batch_size: int) -> tuple[list[int], list[int]]:
    """Per-client (train, val) batch counts — one epoch's step grid.
    Validation always runs at least one (possibly short) batch per client."""
    tr = [n // batch_size for n in n_train]
    va = [max(n, batch_size) // batch_size if n >= batch_size else 1
          for n in n_val]
    return tr, va


def leg_sizes(adapter: SplitAdapter, example_batch: dict, params=None,
              codec=None) -> dict:
    """Per-occurrence byte size of every transfer type ("leg")."""
    if params is None:
        params = adapter.init(None, META)
    specs = adapter.boundary_specs(example_batch, params)

    def wire(tree):
        if codec is None:
            return leaf_bytes(tree)
        return int(sum(codec.wire_bytes(l) for l in tree_leaves(tree)))

    fm = specs["front->middle"]
    mt = specs.get("middle->tail", ())
    return {
        "model": leaf_bytes(params),
        "client_seg": leaf_bytes(params["front"]) + leaf_bytes(
            params.get("tail", {})),
        "act_fm": wire(fm),
        "act_fm_raw": leaf_bytes(fm),
        "act_mt": wire(mt),
        "act_mt_raw": leaf_bytes(mt),
    }


def comm_per_epoch(method: str, adapter: SplitAdapter, example_batch: dict,
                   n_train: list[int], n_val: list[int],
                   batch_size: int, codec=None) -> CommProfile:
    """``n_train``/``n_val``: per-client sample counts."""
    legs = leg_sizes(adapter, example_batch, codec=codec)
    tr_counts, va_counts = client_batch_counts(n_train, n_val, batch_size)
    train_batches, val_batches = sum(tr_counts), sum(va_counts)
    act_fm, act_mt = legs["act_fm"], legs["act_mt"]

    bd = {}
    if method == "centralized":
        total = 0.0
    elif method == "fl":
        bd["model_down"] = legs["model"] * len(n_train)
        bd["model_up"] = legs["model"] * len(n_train)
        total = sum(bd.values())
    else:
        bd["train_act_up"] = act_fm * train_batches
        bd["train_grad_down"] = act_fm * train_batches
        bd["val_act_up"] = act_fm * val_batches
        if adapter.nls:
            bd["train_hidden_down"] = act_mt * train_batches
            bd["train_hidden_grad_up"] = act_mt * train_batches
            bd["val_hidden_down"] = act_mt * val_batches
        if method.startswith("sflv2") or method.startswith("sflv1"):
            bd["client_seg_avg"] = 2 * legs["client_seg"] * len(n_train)
        total = sum(bd.values())
    return CommProfile(method, float(total), bd)
