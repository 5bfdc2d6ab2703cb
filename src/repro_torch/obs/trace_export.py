"""Export a telemetry JSONL log as a Chrome-trace / Perfetto JSON file
(counterpart of ``repro/obs/trace_export.py``).

Produces the classic ``{"traceEvents": [...]}`` format, loadable in
``ui.perfetto.dev`` or ``chrome://tracing``:

  * span records    -> ``ph: "X"`` complete events (ts/dur in microseconds)
  * counter records -> ``ph: "C"`` counter tracks (the running total)
  * gauge records   -> ``ph: "C"`` counter tracks (the sample)
  * event records   -> ``ph: "i"`` instant markers
  * provenance meta -> ``ph: "M"`` process-name metadata and a top-level
                       ``metadata`` block

Spans are laid out per (pid, tid); the emitting thread is not in the
log, so tid is the span's nesting depth, each child one track below its
parent.  A device-timed span (``clock: "cuda_event"``) starts at its
host entry time and lasts its device time.

Usage::

    python -m repro_torch.obs.trace_export telemetry.jsonl trace.json
"""
from __future__ import annotations

import json
from typing import Any, Iterable

from .schema import read_events

_US = 1e6


def to_chrome_trace(events: Iterable[dict[str, Any]]) -> dict[str, Any]:
    events = list(events)
    provenance: dict[str, Any] = {}
    out: list[dict[str, Any]] = []
    depth: dict[int, int] = {}
    for r in events:
        kind, pid = r["kind"], r.get("pid", 0)
        if kind == "meta" and r["name"] == "provenance":
            provenance = r["attrs"]
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {
                            "name": f"repro_torch pid={pid} "
                                    f"({provenance.get('device_kind', '?')})"}})
        elif kind == "span":
            d = depth.get(r.get("parent") or -1, -1) + 1
            depth[r["id"]] = d
            out.append({"ph": "X", "name": r["name"], "pid": pid, "tid": d,
                        "ts": r["ts"] * _US, "dur": r["dur"] * _US,
                        "args": r["attrs"]})
        elif kind in ("counter", "gauge"):
            val = r["total"] if kind == "counter" else r["value"]
            out.append({"ph": "C", "name": r["name"], "pid": pid, "tid": 0,
                        "ts": r["ts"] * _US, "args": {"value": val}})
        elif kind == "event":
            out.append({"ph": "i", "name": r["name"], "pid": pid, "tid": 0,
                        "ts": r["ts"] * _US, "s": "p", "args": r["attrs"]})
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "metadata": {"provenance": provenance}}


def export(log_path: str, out_path: str) -> int:
    """Convert ``log_path`` (JSONL) to ``out_path`` (Chrome trace JSON);
    returns the number of trace events written."""
    trace = to_chrome_trace(read_events(log_path))
    with open(out_path, "w") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Convert a repro_torch telemetry JSONL log into a "
                    "Chrome-trace/Perfetto JSON file.")
    ap.add_argument("log", help="telemetry JSONL path")
    ap.add_argument("out", help="output trace JSON path")
    args = ap.parse_args(argv)
    n = export(args.log, args.out)
    print(f"{args.out}: {n} trace events "
          f"(open in ui.perfetto.dev or chrome://tracing)")
    return 0 if n else 1


if __name__ == "__main__":
    raise SystemExit(main())
