"""repro_torch.obs — run tracing (counterpart of ``repro.obs``' ``trace``):
host spans, the simulated wire lane and the serving lane merged into one
Chrome-trace JSON.  The in-program telemetry, profiling and run reports
come later."""

from repro_torch.obs.trace import (PID_ENGINE, PID_SERVING, PID_WIRE, Tracer,
                                   merge_events, wire_events,
                                   write_chrome_trace)

__all__ = ["Tracer", "merge_events", "wire_events", "write_chrome_trace",
           "PID_ENGINE", "PID_WIRE", "PID_SERVING"]
