"""Run tracing — one merged Chrome-trace/Perfetto JSON per run
(counterpart of ``repro/obs/trace.py``, host code: the port's spans are
host wall-clock, its replays' device time placed on that clock, its wire
lane the simulator's simulated time).

Clock domains, each on its own lane:

  * **engine host** (``PID_ENGINE``): real wall-clock spans recorded by
    ``Tracer`` around the strategy's host phases (run -> pack -> dispatch
    -> h2d, one an epoch: the copies of its batches and round tables to
    the card; ``val_loss``; ``round i`` on the per-epoch path).  A
    compiled run replays every round inside one ``dispatch`` span, so
    ``round_events`` subdivides it into equal per-round slices (flagged
    ``synthetic``) that carry the per-round telemetry as args and the
    cumulative RDP epsilon as Chrome counter (ph "C") tracks;
  * **device** (``PID_ENGINE``, thread ``TID_DEVICE``): one complete span
    a replayed program body, ``replay.<body>`` (``replay.step``,
    ``replay.begin``, ``replay.round``, ...), timed on the card by a pair
    of CUDA timing events recorded on the program's stream around the
    replay (``engine.Program``; a pool of events a program, grown to its
    largest run).  The events are placed on the tracer's clock after the
    run's one readback, when the device is idle: one anchor event is
    recorded there and synchronised on, ``now()`` read, and each stamp
    lands at the anchor's time less its ``elapsed_time`` to the anchor.
    On the CPU a body runs synchronously, and the host clock times the
    same spans;
  * **wire** (``PID_WIRE``): the *simulated*-time transfer timelines from
    ``wire.simulator`` (``simulate`` or ``timeline_from_accounting``) —
    per-client tracks of upload/download events with tag + byte args.
    Simulated seconds are mapped 1:1 onto trace microseconds; the lane is
    a model of the wire, not a measurement;
  * **serving** (``PID_SERVING``): the screening service's per-request
    queue waits and per-batch pad / dispatch / readback spans.

``write_chrome_trace`` emits the standard ``{"traceEvents": [...]}`` JSON
that chrome://tracing and https://ui.perfetto.dev load directly.
"""

from __future__ import annotations

import contextlib
import json
import time

import numpy as np

PID_ENGINE = 1
PID_WIRE = 2
PID_SERVING = 3
#: the engine lane's thread of device spans (``replay.<body>``)
TID_DEVICE = 3


def _meta(pid, name, tid=None, tname=None):
    ev = [{"name": "process_name", "ph": "M", "pid": pid,
           "args": {"name": name}}]
    if tid is not None:
        ev.append({"name": "thread_name", "ph": "M", "pid": pid,
                   "tid": tid, "args": {"name": tname}})
    return ev


class Tracer:
    """Host-side span tree: nested ``with tracer.span(name):`` blocks
    become Chrome complete ("X") events on one engine-host track.  A
    strategy given to ``Strategy.attach_tracer`` records its run / pack /
    dispatch / h2d / val_loss phases here, and its programs' replays on
    the device thread (``TID_DEVICE``)."""

    def __init__(self, pid: int = PID_ENGINE, tid: int = 1):
        self.pid, self.tid = pid, tid
        self.events: list = []
        self._depth = 0
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, **args):
        t0 = self._now_us()
        self._depth += 1
        try:
            yield self
        finally:
            self._depth -= 1
            self.events.append({
                "name": name, "ph": "X", "ts": t0,
                "dur": max(self._now_us() - t0, 0.01),
                "pid": self.pid, "tid": self.tid,
                "args": {**args, "depth": self._depth}})

    def event(self, name: str, t0_s: float, t1_s: float,
              tid: int | None = None, **args) -> None:
        """Record an externally-timed complete span from a pair of
        ``tracer.now()`` readings (seconds since this tracer's epoch) —
        used by the serving front end, whose phases are timed where they
        happen (enqueue in the caller, dispatch in the batcher thread)
        rather than around a single ``with`` block."""
        self.events.append({
            "name": name, "ph": "X", "ts": t0_s * 1e6,
            "dur": max((t1_s - t0_s) * 1e6, 0.01),
            "pid": self.pid, "tid": self.tid if tid is None else tid,
            "args": args})

    def now(self) -> float:
        """Seconds since this tracer's epoch (pairs with ``event``)."""
        return time.perf_counter() - self._t0

    def find(self, name: str) -> dict | None:
        """Most recent finished span with this name (e.g. "dispatch")."""
        for ev in reversed(self.events):
            if ev["name"] == name:
                return ev
        return None

    def trace_events(self) -> list:
        meta = _meta(self.pid, "engine host", self.tid, "strategy")
        if any(e.get("tid") == TID_DEVICE for e in self.events):
            meta += _meta(self.pid, "engine host", TID_DEVICE,
                          "device (CUDA events)")[1:]
        return meta + list(self.events)


def round_events(run_telemetry, dispatch_span=None, pid: int = PID_ENGINE,
                 tid: int = 2) -> list:
    """Per-round telemetry as trace events.

    The compiled run gives the host no per-round timing — every round is
    replayed inside one dispatch span — so rounds are laid out as equal
    slices of the dispatch span (or of a unit span when no tracer ran),
    flagged ``"synthetic": True``.  Each slice carries the round's
    hospital-mean metrics as args; the cumulative per-hospital RDP
    epsilon becomes counter ("C") tracks stepping at round boundaries.
    """
    rounds = run_telemetry.rounds
    if not rounds:
        return []
    if dispatch_span is not None:
        t0, dur = dispatch_span["ts"], dispatch_span["dur"]
    else:
        t0, dur = 0.0, float(len(rounds)) * 1e6
    slice_us = dur / len(rounds)
    out = _meta(pid, "engine host", tid,
                f"rounds ({run_telemetry.strategy}, synthetic)")
    for i, r in enumerate(rounds):
        args = {"synthetic": True}
        for k, v in r.scalars().items():
            if np.isfinite(v):
                args[k] = round(float(v), 6)
        out.append({"name": f"round {r.round_index}", "ph": "X",
                    "ts": t0 + i * slice_us, "dur": slice_us,
                    "pid": pid, "tid": tid, "args": args})
        if r.epsilon is not None:
            eps = np.asarray(r.epsilon, np.float64)
            out.append({"name": f"epsilon ({run_telemetry.strategy})",
                        "ph": "C", "ts": t0 + (i + 1) * slice_us,
                        "pid": pid,
                        "args": {f"hospital{c}": round(float(eps[c]), 6)
                                 for c in range(eps.shape[0])}})
    return out


def wire_events(sim_result, pid: int = PID_WIRE, label: str = "") -> list:
    """``wire.simulator.SimResult`` transfer events as per-client trace
    tracks (simulated seconds -> trace microseconds)."""
    name = f"wire (simulated{', ' + label if label else ''})"
    out = _meta(pid, name)
    clients = sorted({e.client for e in sim_result.events})
    for tid, c in enumerate(clients, start=1):
        out += _meta(pid, name, tid, f"client {c}")[1:]
        for e in sim_result.events:
            if e.client != c:
                continue
            out.append({"name": e.tag, "ph": "X", "ts": e.t_start * 1e6,
                        "dur": max((e.t_end - e.t_start) * 1e6, 0.01),
                        "pid": pid, "tid": tid,
                        "args": {"bytes": int(e.nbytes),
                                 "direction": e.direction}})
    return out


def merge_events(*event_lists, pid_offset: int = 0) -> list:
    """Concatenate event lists into one trace; ``pid_offset`` shifts every
    pid of the merged lists so several strategies' lanes can coexist in
    one file (offset by, say, 10 per strategy)."""
    out = []
    for evs in event_lists:
        for e in evs:
            e = dict(e)
            e["pid"] = e.get("pid", 0) + pid_offset
            out.append(e)
    return out


def write_chrome_trace(events: list, path) -> str:
    """Write ``{"traceEvents": [...]}`` JSON loadable by chrome://tracing
    and Perfetto."""
    path = str(path)
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f, indent=None)
    return path


__all__ = ["Tracer", "round_events", "wire_events", "merge_events",
           "write_chrome_trace", "PID_ENGINE", "PID_WIRE", "PID_SERVING",
           "TID_DEVICE"]
