"""The telemetry record contract (counterpart of ``repro/obs/schema.py``):
one JSON object per JSONL line, the same kinds and fields as the JAX
package's, so each package reads the other's logs.

Common fields (every record):
  kind   'meta' | 'span' | 'counter' | 'gauge' | 'event'
  name   dotted event name ('conv1d.fwd', 'tune.cache.hit', 'train.step')
  ts     seconds since the log's monotonic epoch (float, >= 0)
  attrs  flat JSON object of event attributes
  pid    the emitting process's global rank (``torch.distributed``; 0 in
         a world of one)

Per-kind fields:
  span     dur (seconds), id (int), parent (int | null): the span tree
  counter  value (this increment), total (running total for the name)
  gauge    value (the sample)
  meta     the first record: name='provenance', attrs = the provenance
           block (git sha, torch and CUDA versions, device kind, process
           index, wall_epoch mapping ts=0 to epoch wall time)

``validate`` enforces the contract strictly (tests, the report's
default); ``read_events`` parses a log file back into records.
"""
from __future__ import annotations

import json
from typing import Any

KINDS = ("meta", "span", "counter", "gauge", "event")

_COMMON = {"kind": str, "name": str, "ts": (int, float), "attrs": dict,
           "pid": int}
_PER_KIND = {
    "span": {"dur": (int, float), "id": int, "parent": (int, type(None))},
    "counter": {"value": (int, float), "total": (int, float)},
    "gauge": {"value": (int, float)},
    "event": {},
    "meta": {},
}


def validate(rec: dict[str, Any]) -> dict[str, Any]:
    """Raise ``ValueError`` unless ``rec`` satisfies the schema; returns the
    record unchanged so it chains."""
    if not isinstance(rec, dict):
        raise ValueError(f"record is not an object: {rec!r}")
    kind = rec.get("kind")
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r} in {rec!r}")
    for field, typ in {**_COMMON, **_PER_KIND[kind]}.items():
        if field not in rec:
            raise ValueError(f"{kind} record missing {field!r}: {rec!r}")
        if not isinstance(rec[field], typ):
            raise ValueError(
                f"{kind} record field {field!r} has type "
                f"{type(rec[field]).__name__}, expected {typ}: {rec!r}")
    if rec["ts"] < 0:
        raise ValueError(f"negative ts in {rec!r}")
    if kind == "span" and rec["dur"] < 0:
        raise ValueError(f"negative dur in {rec!r}")
    return rec


def read_events(path: str, *, strict: bool = True) -> list[dict[str, Any]]:
    """Parse one JSONL telemetry log.  ``strict`` validates every record
    (the default everywhere: a malformed log fails loudly rather than
    aggregating quietly)."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}") from e
            out.append(validate(rec) if strict else rec)
    return out
