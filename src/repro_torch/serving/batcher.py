"""Request-batching front end — single images in, coalesced buckets out
(counterpart of ``repro/serving/batcher.py``).

``RequestBatcher`` runs one dispatcher thread over a bounded queue.
Callers submit ONE image at a time (the screening-clinic arrival model);
the dispatcher drains whatever is waiting and scores it as one padded
bucket, waiting at most ``max_wait_s`` after the first arrival for the
batch to fill toward the largest ladder bucket.  The policy:

  * queue non-empty and ``max_wait_s`` expired for the oldest request,
    OR the waiting count reached the largest bucket -> dispatch now with
    the largest ready bucket (``BucketScorer`` pads the remainder).
  * bounded queue (``max_queue``) -> ``submit`` raises ``Backpressure``
    instead of growing latency unboundedly; callers shed or retry.

Per-request latency accounting rides an ``obs.Tracer`` when one is
attached: each request becomes a queue-wait span on an arrivals track plus
batch-level pad / dispatch / readback spans on the dispatcher track
(``PID_SERVING`` lane), so service traces merge with the other lanes via
``merge_events`` into one Chrome-trace file.

``ScreeningService`` is the user-facing bundle: scorer + batcher +
``swap()`` pass-through, with sync ``score_one`` (submit and block) and
``stats()`` (p50/p99 over completed requests).

Grad mode and the current CUDA device are per thread in PyTorch: the
dispatcher thread turns grad off and sets the scorer's device itself.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from repro_torch.obs.trace import PID_SERVING, Tracer, _meta
from repro_torch.serving.scorer import DEFAULT_BUCKETS, BucketScorer


class Backpressure(RuntimeError):
    """Raised by ``submit`` when the request queue is full."""


class _Request:
    __slots__ = ("example", "t_submit", "done", "score", "info", "lat")

    def __init__(self, example: dict):
        self.example = example
        self.t_submit = time.perf_counter()
        self.done = threading.Event()
        self.score = None
        self.info = None
        self.lat = None   # dict of phase latencies (seconds), set on completion


class RequestBatcher:
    """Coalesce single-image submissions into padded-bucket dispatches."""

    def __init__(self, scorer: BucketScorer, max_wait_s: float = 0.002,
                 max_queue: int = 256, tracer: Tracer | None = None):
        self.scorer = scorer
        self.max_wait_s = float(max_wait_s)
        self.max_queue = int(max_queue)
        self.tracer = tracer
        self._q: collections.deque[_Request] = collections.deque()
        self._cv = threading.Condition()
        self._stop = False
        self._completed: list[dict] = []
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-batcher")
        self._thread.start()

    # -- client side -----------------------------------------------------------
    def submit(self, example: dict) -> _Request:
        """Enqueue one example (dict of per-sample arrays, no batch axis);
        returns a handle whose ``done`` event fires when scored.  Raises
        ``Backpressure`` when ``max_queue`` requests are already waiting."""
        req = _Request(example)
        with self._cv:
            if self._stop:
                raise RuntimeError("batcher is closed")
            if len(self._q) >= self.max_queue:
                raise Backpressure(
                    f"serving queue full ({self.max_queue} waiting)")
            self._q.append(req)
            self._cv.notify()
        return req

    def score_one(self, example: dict, timeout: float = 30.0) -> float:
        """Submit and block until scored (the sync client path)."""
        req = self.submit(example)
        if not req.done.wait(timeout):
            raise TimeoutError("scoring request timed out")
        return float(req.score)

    # -- dispatcher ------------------------------------------------------------
    def _take_batch(self) -> list[_Request]:
        """Block until the dispatch policy fires; returns [] on close."""
        b_max = self.scorer.buckets[-1]
        with self._cv:
            while True:
                if self._q:
                    oldest = self._q[0].t_submit
                    if (len(self._q) >= b_max
                            or time.perf_counter() - oldest
                            >= self.max_wait_s):
                        take = min(len(self._q), b_max)
                        return [self._q.popleft() for _ in range(take)]
                    # wake when the oldest request's wait expires
                    self._cv.wait(self.max_wait_s
                                  - (time.perf_counter() - oldest))
                elif self._stop:
                    return []
                else:
                    self._cv.wait()

    def _run(self):
        if self.scorer.device.type == "cuda":
            torch.cuda.set_device(self.scorer.device)
        with torch.no_grad():
            while True:
                reqs = self._take_batch()
                if not reqs:
                    return
                self._dispatch(reqs)

    def _dispatch(self, reqs):
        t_drain = time.perf_counter()
        batch = {k: np.stack([np.asarray(r.example[k]) for r in reqs])
                 for k in reqs[0].example}
        scores, info = self.scorer.score(batch)
        t_done = time.perf_counter()
        for i, r in enumerate(reqs):
            r.score = float(scores[i])
            r.info = info
            r.lat = {
                "total_s": t_done - r.t_submit,
                "queue_s": t_drain - r.t_submit,
                "pad_s": info["pad_s"],
                "dispatch_s": info["dispatch_s"],
                "readback_s": info["readback_s"],
                "bucket": info["buckets"][0] if info["buckets"] else 0,
                "batch_n": len(reqs),
                "version": info["version"],
            }
            self._completed.append(r.lat)
            r.done.set()
        self._trace(reqs, t_drain, t_done, info)

    def _trace(self, reqs, t_drain, t_done, info):
        tr = self.tracer
        if tr is None:
            return
        # batch-level phase spans on the dispatcher track (tid 1)
        d0 = tr.now() - (t_done - t_drain)
        t = d0
        for phase in ("pad", "dispatch", "readback"):
            tr.event(phase, t, t + info[f"{phase}_s"], tid=1,
                     n=len(reqs), bucket=info["buckets"],
                     version=info["version"])
            t += info[f"{phase}_s"]
        # per-request queue-wait spans on an arrivals track (tid 2)
        for r in reqs:
            q0 = d0 - r.lat["queue_s"]
            tr.event("queue_wait", q0, d0, tid=2,
                     total_ms=round(r.lat["total_s"] * 1e3, 3))

    # -- stats / lifecycle -----------------------------------------------------
    def stats(self) -> dict:
        """p50/p99 latency split over every completed request so far."""
        done = self._completed
        if not done:
            return {"n": 0}
        out = {"n": len(done),
               "batch_n_mean": float(np.mean([d["batch_n"] for d in done]))}
        for k in ("total_s", "queue_s", "dispatch_s"):
            v = np.asarray([d[k] for d in done]) * 1e3
            out[f"{k[:-2]}_p50_ms"] = float(np.percentile(v, 50))
            out[f"{k[:-2]}_p99_ms"] = float(np.percentile(v, 99))
        return out

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ScreeningService:
    """Scorer + batcher + hot-swap, bundled: the deployable service.

    ``tracer`` (optional) collects the per-request span lanes; pass
    ``Tracer(pid=PID_SERVING)`` or let the service build one with
    ``trace=True``.
    """

    def __init__(self, servable, image_shape=None, example=None,
                 buckets=None, precision: str = "fp32",
                 max_wait_s: float = 0.002, max_queue: int = 256,
                 trace: bool = False, tracer: Tracer | None = None):
        if tracer is None and trace:
            tracer = Tracer(pid=PID_SERVING)
        self.tracer = tracer
        self.scorer = BucketScorer(
            servable, example=example, image_shape=image_shape,
            buckets=buckets or DEFAULT_BUCKETS, precision=precision)
        self.batcher = RequestBatcher(self.scorer, max_wait_s=max_wait_s,
                                      max_queue=max_queue, tracer=tracer)

    def submit(self, example: dict):
        return self.batcher.submit(example)

    def score_one(self, example: dict, timeout: float = 30.0) -> float:
        return self.batcher.score_one(example, timeout=timeout)

    def score_batch(self, batch: dict):
        """Direct batch path (bypasses the queue — offline eval)."""
        return self.scorer.score(batch)

    def swap(self, params_or_servable) -> int:
        return self.scorer.swap(params_or_servable)

    @property
    def version(self) -> int:
        return self.scorer.version

    def stats(self) -> dict:
        return self.batcher.stats()

    def trace_events(self) -> list:
        if self.tracer is None:
            return []
        return _meta(self.tracer.pid, "screening service", 1, "dispatcher") \
            + _meta(self.tracer.pid, "screening service", 2, "arrivals")[1:] \
            + list(self.tracer.events)

    def close(self):
        self.batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["RequestBatcher", "ScreeningService", "Backpressure"]
