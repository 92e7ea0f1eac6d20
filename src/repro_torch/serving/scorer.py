"""Batched scoring core — the deploy side's hot path (counterpart of
``repro/serving/scorer.py``).

``BucketScorer`` builds ONE scoring program per bucket of a fixed
batch-size ladder at construction: on the card a captured CUDA graph of
``adapter.full_scores`` over static input and parameter buffers
(``core.strategies.engine.Program``, the buckets' graphs in one memory
pool); on the CPU the same body run eagerly over the same buffers.  A
request batch of n images is padded (repeating the last row; padded
scores are sliced off) up to the smallest bucket >= n, and batches beyond
the largest bucket chunk through it, so no request shape ever captures
anew: ``n_compiles`` (the captures) is ``len(buckets)`` on the card after
construction and never moves; ``n_dispatches`` counts replays.

``ModelSlot`` is the hot-swap handle: ``swap`` uploads a new version to
the device and replaces the ``(version, params)`` pair atomically.  A
replay reads the static buffers, so each ``score`` call holds the
scorer's lock while it copies a newer version into them (device to
device), fills the inputs, replays and reads back: every call serves
exactly one version, never a torn tree.

``precision="bf16"`` keeps bf16 static params (cast once per swap) and
casts the float inputs inside the program; the scores stay f32
(``scores_from_output``).  cuDNN picks algorithms by batch size, so a
bucket's scores agree with ``Strategy.scores`` within 1e-5 in f32 (0.05
in bf16), not bit for bit.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from repro_torch.core.partition import META
from repro_torch.core.strategies.engine import Program
from repro_torch.serving.export import ServableModel
from repro_torch.tree import tree_leaves, tree_map

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
PRECISIONS = ("fp32", "bf16")


def _shapes(tree):
    """``tree``'s structure with each leaf's shape in its place."""
    return tree_map(lambda l: tuple(l.shape), tree)


class ModelSlot:
    """Versioned parameter handle: ``get()`` returns the current
    ``(version, params)`` pair, ``swap`` replaces it atomically."""

    def __init__(self, params, version: int = 0):
        self._ref = (version, params)
        self._lock = threading.Lock()

    @property
    def version(self) -> int:
        return self._ref[0]

    def get(self):
        return self._ref

    def swap(self, params) -> int:
        """Install a new param tree behind the handle; returns the new
        version.  The structure and every leaf's shape must match the
        incumbent's (a federated round updates values, never shapes)."""
        with self._lock:
            version, old = self._ref
            if (tree_map(lambda _: 0, params)
                    != tree_map(lambda _: 0, old)):
                raise ValueError("swap() param tree structure differs from "
                                 "the serving model's — export/strategy "
                                 "mismatch")
            if _shapes(params) != _shapes(old):
                raise ValueError("swap() param leaf shapes differ from the "
                                 "serving model's")
            self._ref = (version + 1, params)
            return version + 1


class _BucketProgram(Program):
    """One bucket's scoring body over static buffers: the scorer's params
    (shared by every bucket), this bucket's inputs and its scores."""

    bodies = ("score",)

    def __init__(self, device, pool, score_fn, params, inputs, out):
        super().__init__(device)
        self.pool = pool
        self.score_fn = score_fn
        self.params, self.inputs, self.out = params, inputs, out

    def carry(self):
        return [self.out]

    def _score(self):
        self.out.copy_(self.score_fn(self.params, self.inputs))


class BucketScorer:
    """Padded-bucket scoring programs behind a hot-swappable slot.

    ``servable``: the exported model (params on its device, where the
    programs run).  ``example``: a dict of ONE example's arrays (no batch
    axis) fixing the request shapes; defaults to zeros shaped from
    ``image_shape`` for the CNN families.
    """

    def __init__(self, servable: ServableModel, example: dict | None = None,
                 image_shape: tuple | None = None,
                 buckets=DEFAULT_BUCKETS, precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r} "
                             f"(one of {PRECISIONS})")
        if example is None:
            if image_shape is None:
                raise ValueError("BucketScorer needs an example dict or an "
                                 "image_shape")
            example = {"image": np.zeros(image_shape, np.float32)}
        self.servable = servable
        self.example = {k: np.asarray(v) for k, v in example.items()}
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError("buckets must be positive ints")
        self.precision = precision
        self.device = tree_leaves(servable.params)[0].device
        self.n_dispatches = 0
        self._lock = threading.Lock()
        self.slot = ModelSlot(self._upload(servable.params))
        self._params = tree_map(torch.clone, self.slot.get()[1])
        self._loaded = self.slot.version
        fs = servable.adapter.full_scores
        cast = precision == "bf16"

        def score_fn(params, batch):
            if cast:
                batch = tree_map(lambda l: l.to(torch.bfloat16)
                                 if l.is_floating_point() else l, batch)
            return fs(params, batch)

        meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device=META), self._params)
        pool = (torch.cuda.graph_pool_handle()
                if self.device.type == "cuda" else None)
        self._progs = {}
        with torch.no_grad(), self._on_device():
            for b in self.buckets:
                inputs = {k: torch.zeros((b, *v.shape),
                                         dtype=torch.from_numpy(v).dtype,
                                         device=self.device)
                          for k, v in self.example.items()}
                spec = score_fn(meta, {k: torch.empty(
                    v.shape, dtype=v.dtype, device=META)
                    for k, v in inputs.items()})
                out = torch.empty(spec.shape, dtype=spec.dtype,
                                  device=self.device)
                prog = _BucketProgram(self.device, pool, score_fn,
                                      self._params, inputs, out)
                prog("score")            # on the card: warm up, capture
                self._progs[b] = prog

    @property
    def n_compiles(self) -> int:
        """Captured bucket programs (0 on the CPU, which captures none)."""
        return sum(p.captures for p in self._progs.values())

    def _on_device(self):
        return (torch.cuda.device(self.device)
                if self.device.type == "cuda" else contextlib.nullcontext())

    def _upload(self, params):
        """A new version on the scorer's device, in its precision (bf16:
        cast here, once per swap)."""
        def one(t):
            t = torch.as_tensor(t)
            bf16 = self.precision == "bf16" and t.is_floating_point()
            return t.to(self.device, torch.bfloat16 if bf16 else t.dtype,
                        copy=True)
        return tree_map(one, params)

    # -- hot swap --------------------------------------------------------------
    def swap(self, params_or_servable) -> int:
        """Install a new export behind the live programs (the next ``score``
        call copies it into the static buffers)."""
        params = (params_or_servable.params
                  if isinstance(params_or_servable, ServableModel)
                  else params_or_servable)
        return self.slot.swap(self._upload(params))

    @property
    def version(self) -> int:
        return self.slot.version

    # -- scoring ---------------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest ladder bucket >= n (the largest bucket for chunking)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    @staticmethod
    def _pad_to(batch: dict, b: int) -> dict:
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            if len(v) < b:
                v = np.concatenate([v, np.repeat(v[-1:], b - len(v),
                                                 axis=0)])
            v = np.ascontiguousarray(v)
            out[k] = torch.from_numpy(v if v.flags.writeable else v.copy())
        return out

    def score(self, batch: dict):
        """Score a request batch; returns ``(scores, info)`` with scores
        ``(n,)`` float32 and ``info`` carrying the model version served,
        the pad / dispatch / readback wall-clock split and the bucket(s)
        used.  Never captures: every shape routes through the ladder."""
        n = len(next(iter(batch.values())))
        info = {"version": self.slot.version, "buckets": [], "pad_s": 0.0,
                "dispatch_s": 0.0, "readback_s": 0.0, "n_dispatch": 0}
        if n == 0:
            return np.zeros((0,), np.float32), info
        b_max = self.buckets[-1]
        outs = []
        with self._lock, torch.no_grad(), self._on_device():
            version, params = self.slot.get()
            if version != self._loaded:
                tree_map(lambda d, s: d.copy_(s), self._params, params)
                self._loaded = version
            info["version"] = version
            for s in range(0, n, b_max):
                m = min(b_max, n - s)
                b = self.bucket_for(m)
                prog = self._progs[b]
                t0 = time.perf_counter()
                padded = self._pad_to({k: np.asarray(v)[s:s + b_max]
                                       for k, v in batch.items()}, b)
                t1 = time.perf_counter()
                for k, v in padded.items():
                    prog.inputs[k].copy_(v)
                prog("score")
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t2 = time.perf_counter()
                out = prog.out.to("cpu", copy=True).numpy()
                outs.append(out.reshape(b, -1)[:m, 0] if out.ndim > 1
                            else out[:m])
                t3 = time.perf_counter()
                self.n_dispatches += 1
                info["buckets"].append(b)
                info["pad_s"] += t1 - t0
                info["dispatch_s"] += t2 - t1
                info["readback_s"] += t3 - t2
                info["n_dispatch"] += 1
        return (np.concatenate(outs).astype(np.float32, copy=False)
                .reshape(-1), info)


__all__ = ["ModelSlot", "BucketScorer", "DEFAULT_BUCKETS", "PRECISIONS"]
