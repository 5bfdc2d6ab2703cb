"""repro_torch.obs — the port's telemetry: event bus, scoreboard, trace
export (counterpart of ``repro.obs``; the same record contract, so each
package reads the other's logs).

Off by default; every hook's disabled path is a single ``is None`` check
(no allocation, no I/O, under a microsecond).  Enable with
``REPRO_TORCH_TELEMETRY=1`` (sink path from
``REPRO_TORCH_TELEMETRY_PATH``, default ``repro_torch_telemetry.jsonl``),
with ``--telemetry PATH`` on either launcher, or explicitly:

    >>> import tempfile
    >>> from repro_torch import obs
    >>> path = obs.enable(tempfile.mkstemp(suffix=".jsonl")[1])
    >>> with obs.span("demo.outer", note="hi"):
    ...     with obs.span("demo.inner"):
    ...         pass
    >>> obs.counter("demo.count", 2)
    >>> obs.counters()["demo.count"]
    2
    >>> obs.disable()
    >>> [r["name"] for r in obs.read_events(path)]  # spans emit at exit
    ['provenance', 'demo.inner', 'demo.outer', 'demo.count']
    >>> obs.read_events(path)[2]["attrs"]["note"]
    'hi'

What is instrumented where:
  * ``kernels/ops.py``      — a ``conv1d.<pass>`` span around every pass
    (the forward, bwd-data with its model sums, bwd-weight up to its
    reduces' issue), with flops, GFLOP/s and on a card the achieved
    fraction of the peak; device-timed on a card (``bus.device_span``);
    a ``conv.psum.model`` event per dx sum over the model group.
  * ``repro_torch.tune``    — cache hit/miss counters and per-candidate
    search events (predicted vs measured seconds) under a
    ``tune.search`` span.
  * ``launch/train.py``     — per-step spans (data / step), the probe
    step's phases (forward / backward / optimizer / psum), per-rank
    step-time gauges, health and straggler verdicts and rollups.
  * ``train/serve_step.py`` — request-latency spans
    (``with_request_spans``), used by ``launch/serve.py``.
  * ``train/data_parallel.py`` — the ``train.mesh`` event (dp, mp).

Consumers: ``python -m repro_torch.obs.report LOG [--check]`` (the
scoreboard) and ``python -m repro_torch.obs.trace_export LOG OUT`` (a
Chrome/Perfetto trace).
"""
from __future__ import annotations

from .bus import (DEFAULT_PATH, ENV_TELEMETRY, ENV_TELEMETRY_PATH,
                  NOOP_SPAN, Span, _env_enable, counter, counters,
                  device_span, disable, enable, enabled, event, flush, gauge,
                  log_path, span, span_event)
from .provenance import provenance
from .schema import read_events, validate

_env_enable()

__all__ = [
    "DEFAULT_PATH", "ENV_TELEMETRY", "ENV_TELEMETRY_PATH", "NOOP_SPAN",
    "Span", "counter", "counters", "device_span", "disable", "enable",
    "enabled", "event", "flush", "gauge", "log_path", "provenance",
    "read_events", "span", "span_event", "validate",
]
