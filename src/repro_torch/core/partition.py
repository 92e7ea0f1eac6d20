"""Cut-layer model partitioning — counterpart of ``repro/core/partition.py``.

A model is wrapped into a uniform ``SplitAdapter`` so the strategies are
architecture-agnostic.  Segments:

  * ``front``  — at the client; raw inputs never leave it.
  * ``middle`` — at the server (the bulk of the compute).
  * ``tail``   — at the client again, only in the non-label-sharing
    (U-shaped) configuration; holds the head so labels never leave either.

Activations crossing segment boundaries may be pytrees (the U-Net front
emits (hidden, skips)); communication accounting sums leaf bytes.
Boundary shapes are computed on the ``meta`` device: no memory, no compute.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class SplitAdapter:
    """Uniform three-segment view of a model for the distributed strategies."""
    name: str
    seg_names: tuple[str, ...]                 # ("front", "middle"[, "tail"])
    init: Callable[..., Any]                   # (generator, device) -> params
    inputs: Callable[[dict], Any]              # batch -> x0
    apply_seg: Callable[..., Any]              # (seg, seg_params, x, batch, train) -> x
    loss_from_output: Callable[[Any, dict], Any]
    scores_from_output: Callable[[Any], Any]   # output -> probabilities
    per_example_loss: Callable[[Any, dict], Any]   # output -> (B,)
    batch_keys: tuple[str, ...] = ()           # what a step reads of a batch

    @property
    def nls(self) -> bool:
        return "tail" in self.seg_names

    def full_loss(self, params, batch, train=True, boundary=None,
                  weights=None):
        """``boundary``: optional fn applied to every cross-segment
        activation tree (the ``repro_torch.wire`` transport hook: the next
        segment sees what crossed the wire).  ``weights``: optional (B,)
        per-example weights; the loss is then their weighted mean of the
        per-example losses, which is how the compiled engine keeps the
        padding rows of a pad-and-mask remainder batch out of the loss."""
        x = self.inputs(batch)
        last = len(self.seg_names) - 1
        for i, seg in enumerate(self.seg_names):
            x = self.apply_seg(seg, params[seg], x, batch, train)
            if boundary is not None and i < last:
                x = boundary(x)
        if weights is None:
            return self.loss_from_output(x, batch)
        pe = self.per_example_loss(x, batch).float()
        w = weights.float()
        return (pe * w).sum() / torch.clamp_min(w.sum(), 1.0)

    def full_scores(self, params, batch):
        x = self.inputs(batch)
        for seg in self.seg_names:
            x = self.apply_seg(seg, params[seg], x, batch, False)
        return self.scores_from_output(x)

    # -- boundary shape accounting (for repro_torch.core.comm) --------------
    def boundary_specs(self, example_batch: dict, params=None) -> dict:
        """Meta tensors with the shape and dtype of every segment-boundary
        activation tree (NHWC, as in the reference)."""
        if params is None:
            params = self.init(None, META)
        b = {k: as_meta(v) for k, v in example_batch.items()}
        with torch.no_grad():
            h = self.apply_seg("front", params["front"], self.inputs(b), b,
                               True)
            specs = {"front->middle": h}
            if self.nls:
                specs["middle->tail"] = self.apply_seg(
                    "middle", params["middle"], h, b, True)
        return specs


def as_meta(v) -> torch.Tensor:
    """A numpy array or tensor -> an empty meta tensor of its shape/dtype."""
    if isinstance(v, torch.Tensor):
        return torch.empty(v.shape, dtype=v.dtype, device=META)
    v = np.asarray(v)
    dtype = torch.from_numpy(np.empty((0,), v.dtype)).dtype
    return torch.empty(v.shape, dtype=dtype, device=META)


def cnn_adapter(model) -> SplitAdapter:
    """Wrap a ``repro_torch.models.cnn.CNNModel``."""
    from repro_torch.models.cnn import bce_loss, bce_terms

    def inputs(batch):
        return batch["image"]

    def apply_seg(seg, seg_params, x, batch, train=False):
        return model.apply_segment(seg_params, seg, x, train)

    def loss_from_output(out, batch):
        return bce_loss(out, batch["label"])

    def scores_from_output(out):
        return torch.sigmoid(out.reshape(-1).float())

    def per_example_loss(out, batch):
        return bce_terms(out, batch["label"])

    return SplitAdapter(model.name, tuple(model.seg_names), model.init_params,
                        inputs, apply_seg, loss_from_output,
                        scores_from_output, per_example_loss,
                        batch_keys=("image", "label"))


def lm_adapter(model) -> SplitAdapter:
    """Wrap a ``repro_torch.models.transformer.TransformerLM`` (built with
    its cut, LS or NLS).  A batch is ``{"tokens": (B, S + 1)[,
    "frontend_emb": (B, F, dim)]}``; each segment runs alone
    (``segment_range``) with positions that count a frontend's prefix,
    and the losses score the text positions only.  As in the reference,
    the MoE balance losses stay out of the adapter's losses and the
    padding slots of a padded vocabulary stay in its softmax."""
    seg_names = tuple(s.name for s in model.segments)
    seg_index = {s.name: i for i, s in enumerate(model.segments)}

    def inputs(batch):
        return batch["tokens"][:, :-1]

    def positions(batch):
        b, s = batch["tokens"].shape
        fe = batch.get("frontend_emb")
        total = s - 1 + (fe.shape[1] if fe is not None else 0)
        return torch.arange(total, dtype=torch.int32,
                            device=batch["tokens"].device).expand(b, total)

    def apply_seg(seg, seg_params, x, batch, train=False):
        i = seg_index[seg]
        out, _, _ = model.apply({seg: seg_params}, x,
                                positions=positions(batch),
                                frontend_emb=batch.get("frontend_emb"),
                                train=train, segment_range=(i, i + 1))
        return out

    def token_nll(logits, batch):
        labels = batch["tokens"][:, 1:].long()
        logits = logits[:, -labels.shape[1]:].float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
        return lse - ll                               # (B, S)

    def loss_from_output(logits, batch):
        return token_nll(logits, batch).mean()

    def per_example_loss(logits, batch):
        return token_nll(logits, batch).mean(-1)

    def scores_from_output(logits):
        return torch.softmax(logits.float(), dim=-1)

    return SplitAdapter(model.cfg.name, seg_names, model.init_params, inputs,
                        apply_seg, loss_from_output, scores_from_output,
                        per_example_loss)


PRECISIONS = ("fp32", "bf16")


def cast_adapter(adapter: SplitAdapter, precision: str) -> SplitAdapter:
    """Mixed-precision view of an adapter: bf16 compute, f32 masters.

    With ``precision="bf16"`` every TRAINING segment application casts its
    floating params and activations to bfloat16 before the underlying
    ``apply_seg``, so the convolutions of the forward and backward run in
    bf16 while the params the optimizer owns stay f32: autograd carries
    the gradient back through the cast and it arrives in f32.  Master
    params, optimizer state, aggregation and the losses (every adapter
    reduces them in f32) stay f32, and evaluation (``train=False``) is
    untouched.  Boundary specs inherit the cast (the training activations
    ARE bf16 on the wire), so the analytic wire bytes are bf16 bytes.
    ``precision="fp32"`` returns the adapter itself.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} "
                         f"(one of {PRECISIONS})")
    if precision == "fp32":
        return adapter

    def cast(tree):
        return tree_map(lambda l: l.to(torch.bfloat16)
                        if l.is_floating_point() else l, tree)

    inner = adapter.apply_seg

    def apply_seg(seg, seg_params, x, batch, train=False):
        if not train:
            return inner(seg, seg_params, x, batch, train)
        return inner(seg, cast(seg_params), cast(x), batch, train)

    return dataclasses.replace(adapter, apply_seg=apply_seg)


@torch.no_grad()
def grid_scores(adapter: SplitAdapter, params, data: dict, batch_size: int,
                chunk_batches: int | None = None) -> np.ndarray:
    """Per-sample scores (``adapter.full_scores``) of every sample of
    ``data`` (numpy arrays), on the reference's pad-and-slice grid: batches
    of ``bs = min(batch_size, n)``, the last padded by repeating its final
    row, the padded rows' scores sliced off.  The grid moves to the params'
    device ``chunk_batches`` batches at a time (all at once by default);
    every batch is one forward whatever the chunking, so the scores do not
    depend on it.  ``Strategy.scores`` and ``ServableModel.scores`` both
    call this, so an export scores as its strategy does, bit for bit."""
    n = len(next(iter(data.values())))
    if n == 0:
        return np.zeros((0,))
    bs = min(batch_size, n)
    nb = -(-n // bs)
    ch = nb if chunk_batches is None else int(chunk_batches)
    if ch < 1:
        raise ValueError("chunk_batches must be >= 1")
    device = tree_leaves(params)[0].device
    keys = [k for k in (adapter.batch_keys or data) if k in data]
    grid = {}
    for k in keys:
        v = np.asarray(data[k])
        if len(v) != nb * bs:
            v = np.concatenate([v, np.repeat(v[-1:], nb * bs - n, axis=0)])
        grid[k] = torch.from_numpy(np.ascontiguousarray(v))
    out = []
    for c in range(0, nb, ch):
        rows = slice(c * bs, min(c + ch, nb) * bs)
        chunk = {k: v[rows].to(device) for k, v in grid.items()}
        out += [adapter.full_scores(params, {k: v[s:s + bs]
                                             for k, v in chunk.items()})
                for s in range(0, len(chunk[keys[0]]), bs)]
    return torch.cat(out).cpu().numpy()[:n]


def leaf_bytes(tree) -> int:
    return int(sum(l.numel() * l.element_size() for l in tree_leaves(tree)))


def detached(tree, requires_grad=False):
    """Fresh leaf tensors of ``tree`` (for one step's autograd graph)."""
    return tree_map(lambda t: t.detach().requires_grad_(requires_grad), tree)
