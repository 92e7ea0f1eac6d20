"""Run reports — ``RUNLOG_<name>.json`` + a markdown summary per run
(counterpart of ``repro/obs/report.py``, the same files).

The JSON runlog is the machine-readable record: the full per-round x
per-hospital telemetry (``RunTelemetry.to_json``), the strategy's cost
summary (``obs.profile.cost_summary``: replays, capture seconds, kernel
launches per replay, step FLOPs, peak memory) and any extra sections the
caller supplies (wire accounting, eval metrics).  The markdown report
renders the same telemetry as a per-round table for humans.
"""

from __future__ import annotations

import json
import os


def write_runlog(out_dir, name: str, telemetry=None, cost=None,
                 extra: dict | None = None) -> str:
    """Write ``RUNLOG_<name>.json`` under ``out_dir`` and return its path."""
    os.makedirs(str(out_dir), exist_ok=True)
    doc: dict = {"name": name}
    if telemetry is not None:
        doc["telemetry"] = telemetry.to_json()
    if cost is not None:
        doc["cost"] = cost
    if extra:
        doc.update(extra)
    path = os.path.join(str(out_dir), f"RUNLOG_{name}.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, default=float)
    return path


def render_markdown(telemetry, cost=None, title: str | None = None) -> str:
    """Markdown run report: per-round telemetry table + cost footer."""
    lines = [f"# Run report: {title or telemetry.strategy}", ""]
    lines.append(telemetry.table())
    if cost is not None:
        lines += ["", "## Cost", ""]
        for k, v in cost.items():
            if isinstance(v, dict):
                v = json.dumps(v, default=float)
            lines.append(f"- **{k}**: {v}")
    return "\n".join(lines) + "\n"


def write_report(out_dir, name: str, telemetry, cost=None) -> str:
    """Write ``REPORT_<name>.md`` alongside the runlog."""
    os.makedirs(str(out_dir), exist_ok=True)
    path = os.path.join(str(out_dir), f"REPORT_{name}.md")
    with open(path, "w") as f:
        f.write(render_markdown(telemetry, cost, title=name))
    return path


__all__ = ["write_runlog", "render_markdown", "write_report"]
