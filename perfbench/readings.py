"""Helpers the metric readers share: device time by kernel class over a
traced run's record (``harness.traced_record``)."""

from __future__ import annotations

from perfbench.trace import class_of


def class_us(rec: dict, classes: tuple) -> float:
    """Device microseconds of the kernels of ``classes``."""
    return sum(b - a for n, a, b in rec["kernels"]
               if class_of(n, rec["classes"]) in classes)
