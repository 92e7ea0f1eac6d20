"""repro_torch.obs — observability for the compiled multi-hospital engine
(counterpart of ``repro.obs``).  Four layers, threaded through the
strategy stack:

  * ``telemetry`` — in-program metric taps inside the captured steps
                    (``Telemetry`` spec; per-round x per-hospital stats);
  * ``trace``     — host spans merged with the wire simulator's transfer
                    timelines, the serving lane and the per-round epsilon
                    into one Chrome-trace/Perfetto JSON;
  * ``profile``   — ``torch.profiler`` traces and the captured graphs'
                    costs (captures, replays, launches, FLOPs, memory);
  * ``report``    — ``RUNLOG_*.json`` + markdown run reports.
"""

from repro_torch.obs.telemetry import (RoundTelemetry, RunTelemetry,
                                       Telemetry, as_telemetry)
from repro_torch.obs.trace import (PID_ENGINE, PID_SERVING, PID_WIRE, Tracer,
                                   merge_events, round_events, wire_events,
                                   write_chrome_trace)
from repro_torch.obs.profile import cost_summary, graph_cost, torch_profile
from repro_torch.obs.report import (render_markdown, write_report,
                                    write_runlog)

__all__ = ["Telemetry", "RoundTelemetry", "RunTelemetry", "as_telemetry",
           "Tracer", "merge_events", "round_events", "wire_events",
           "write_chrome_trace", "PID_ENGINE", "PID_WIRE", "PID_SERVING",
           "cost_summary", "graph_cost", "torch_profile", "render_markdown",
           "write_report", "write_runlog"]
