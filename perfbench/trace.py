"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI) over
whole epochs of the window, reduced to kernel intervals, the device's busy
time (the union of the intervals: a CUDA graph runs independent branches
side by side, so kernel times can add up to more than the wall), device
time by kernel class, and the idle gaps named by what the host was doing.

The harness marks its own calls with ``span`` (``bench.<name>`` ranges in
the profiler's CPU track); the program's tracer spans (``pack``,
``dispatch``) are mapped onto the profiler's clock through one marker
whose host time is known.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
PREFIX = "bench."


def kernel_classes() -> list:
    return json.loads((HERE / "kernel_classes.json").read_text())["classes"]


def class_of(name: str, classes: list) -> str:
    for cls, frags in classes:
        if any(f in name for f in frags):
            return cls
    return "other"


def span(name: str):
    """A harness span on the profiler's CPU track (inert unprofiled)."""
    return torch.profiler.record_function(PREFIX + name)


class DeviceTrace:
    """Profile a block of whole epochs; ``record()`` after it ends."""

    def __init__(self):
        self.prof = None
        self.mark_host = None

    @contextlib.contextmanager
    def profiling(self):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            self.prof = prof
            self.mark_host = time.perf_counter()
            with span("mark"):
                pass
            yield self

    def record(self, host_spans: list) -> dict:
        """Kernel intervals and named spans, in microseconds of the
        profiler's clock, and the profiled block's start on it.
        ``host_spans``: (name, start, end) in ``time.perf_counter`` seconds
        (the program's tracer spans)."""
        from torch.autograd import DeviceType

        kernels, spans, mark = [], [], None
        # the profiler's raw events (``prof.events()`` builds a Python tree
        # of them: minutes at hundreds of thousands of kernels)
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            a = e.start_ns() / 1e3
            b = a + e.duration_ns() / 1e3
            cuda = e.device_type() == DeviceType.CUDA
            if name.startswith(PREFIX):
                # the CPU range, and its copy on the device track (a user
                # annotation, no kernel)
                if cuda:
                    continue
                name = name[len(PREFIX):]
                if name == "mark":
                    mark = a
                else:
                    spans.append((name, a, b))
            elif cuda:
                kernels.append((name, a, b))
        if mark is not None:
            off = mark - self.mark_host * 1e6
            spans += [(n, s * 1e6 + off, t * 1e6 + off)
                      for n, s, t in host_spans]
        kernels.sort(key=lambda k: k[1])
        return {"kernels": kernels, "spans": spans,
                "start_us": mark if mark is not None else 0.0}


def busy_intervals(kernels: list) -> list:
    """The union of the kernels' intervals, merged, in start order."""
    out = []
    for _, a, b in sorted(kernels, key=lambda k: k[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_us(kernels: list) -> float:
    return sum(b - a for a, b in busy_intervals(kernels))


def idle_gaps(kernels: list, spans: list, lo: float, hi: float) -> list:
    """[(name, seconds)] of every stretch of [lo, hi] in which no kernel
    ran, longest first, each named by the innermost span around its middle
    (``between`` outside every span)."""
    gaps, t = [], lo
    for a, b in busy_intervals(kernels):
        if a > t:
            gaps.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        gaps.append((t, hi))
    out = []
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) / 2
        around = [(e - s, n) for n, s, e in spans if s <= mid <= e]
        out.append((min(around)[1] if around else "between", (b - a) / 1e6))
    return sorted(out, key=lambda g: -g[1])


def device_ops(kernels: list, top: int = 10, width: int = 200) -> list:
    """[(kernel name, seconds)] of the kernels that took most device
    time, summed over their launches (names cut to ``width``)."""
    tot: dict = {}
    for n, a, b in kernels:
        n = n[:width]
        tot[n] = tot.get(n, 0.0) + (b - a) / 1e6
    return sorted(tot.items(), key=lambda kv: -kv[1])[:top]
