"""Process-local telemetry event bus with a JSONL sink (counterpart of
``repro/obs/bus.py``).

One ``_Bus`` per process (a module-level singleton), **off by default**:
every public hook checks ``_BUS is None`` first, so a disabled hook is a
handful of bytecode ops, with no allocation and no I/O (held under a
microsecond in ``tests/test_torch_obs.py``).

Primitives (all no-ops while disabled):

  * ``span(name, **attrs)``        — context manager timing a region on
                                     the host clock (``perf_counter``);
                                     spans nest through a thread-local
                                     stack and each record carries its
                                     parent's id.
  * ``device_span(name, device, ...)`` — the same around work enqueued
                                     on a CUDA device: two CUDA events on
                                     the current stream bracket it and
                                     ``dur`` is the device time between
                                     them (module docstring below).
  * ``span_event(name, dur, ...)`` — a span whose duration the caller
                                     measured (derived phases).
  * ``counter(name, value)``       — monotonic increment; the bus keeps
                                     running totals (``counters()``) and
                                     logs every increment.
  * ``gauge(name, value)``         — point-in-time sample.
  * ``event(name)``                — zero-duration marker.

**Device spans.**  The port runs eagerly: a pass returns as soon as its
kernels are enqueued.  Timing it on the host would need a synchronize per
pass, which would serialize a training step (and the gradient reduces
that overlap its backward).  A ``device_span`` on a CUDA device records a
start and an end event on the current stream instead and keeps the span
pending; its record is written when the events are read, at
:func:`flush` (which a caller runs after it has synchronized, as the
launchers do after each step), at :func:`disable`, or when
``MAX_PENDING`` spans wait.  Its attrs then carry ``clock:
"cuda_event"``, and ``dur`` is the device time from the start event to
the end event.  When the host keeps ahead of the device that is the
kernels' time; when the step is host-bound the stream drains between
launches, the events run as soon as they are enqueued, and ``dur`` also
holds the host's gaps inside the region: it lies between the kernels'
device time and the call's time.  ``ts`` is the host time at entry.
While the current stream is capturing a CUDA graph no event may be
recorded and nothing is timed: the span logs a zero-duration
``<name>.trace`` event with its attrs instead (as the JAX package does
for a traced pass).  On a CPU device ``device_span`` is ``span``.

**Ranks.**  Every record's ``pid`` is the process's global rank at the
time it is written (``provenance.process_index``), so a bus opened
before the process group starts still labels its records by rank.  The
ranks of one run may share one path: the sink is opened in append mode
and each record is one ``write`` of one whole line, so lines of two
ranks never interleave.
"""
from __future__ import annotations

import json
import os
import threading
import time
from itertools import count
from typing import Any, Callable

from .provenance import process_index

ENV_TELEMETRY = "REPRO_TORCH_TELEMETRY"
ENV_TELEMETRY_PATH = "REPRO_TORCH_TELEMETRY_PATH"
DEFAULT_PATH = "repro_torch_telemetry.jsonl"
MAX_PENDING = 4096  # device spans waiting before a flush is forced

_BUS: "_Bus | None" = None


class _Bus:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT,
                           0o644)
        self._lock = threading.Lock()
        self._ids = count(1)
        self._local = threading.local()
        self.pending: list[Span] = []
        self.epoch = time.perf_counter()
        self.wall_epoch = time.time()
        self.totals: dict[str, float] = {}
        from .provenance import provenance
        self.emit({"kind": "meta", "name": "provenance", "ts": 0.0,
                   "attrs": dict(provenance(), wall_epoch=self.wall_epoch)})

    # -- plumbing -----------------------------------------------------------

    def now(self) -> float:
        return time.perf_counter() - self.epoch

    def stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def emit(self, rec: dict[str, Any]) -> None:
        rec.setdefault("pid", process_index())
        data = (json.dumps(rec, default=str) + "\n").encode()
        with self._lock:
            while data:  # one write a line; a regular file takes it whole
                data = data[os.write(self._fd, data):]

    def close(self) -> None:
        with self._lock:
            os.close(self._fd)


class Span:
    """One timed region.  Emitted at ``__exit__`` (a device span: at the
    flush after it); ``attrs`` may be mutated inside the ``with`` block,
    and ``close_attrs(dur_seconds)``, if given, supplies duration-derived
    attrs (e.g. achieved fraction of peak) at close time.  ``dur`` is
    readable after the block (a device span: after the flush)."""

    __slots__ = ("name", "attrs", "close_attrs", "id", "parent", "_t0",
                 "ts", "dur", "device", "_ev")

    def __init__(self, name: str, attrs: dict,
                 close_attrs: Callable[[float], dict] | None = None,
                 device=None):
        self.name = name
        self.attrs = attrs
        self.close_attrs = close_attrs
        self.device = device  # a CUDA device: timed by events
        self._ev = None
        self.dur = None

    def __enter__(self) -> "Span":
        bus = _BUS
        self.id = None
        self._t0 = time.perf_counter()
        if bus is None:  # disabled between construction and entry
            return self
        if self.device is not None:
            import torch
            if torch.cuda.is_current_stream_capturing():
                # nothing may be recorded or read inside a capture
                bus.emit({"kind": "event", "name": f"{self.name}.trace",
                          "ts": bus.now(), "attrs": self.attrs})
                return self
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            self._ev[0].record(torch.cuda.current_stream(self.device))
        st = bus.stack()
        self.id = next(bus._ids)
        self.parent = st[-1] if st else None
        st.append(self.id)
        self.ts = bus.now()
        return self

    def __exit__(self, *exc) -> None:
        bus = _BUS
        if bus is None or self.id is None:
            self.dur = time.perf_counter() - self._t0
            return
        st = bus.stack()
        if st and st[-1] == self.id:
            st.pop()
        if self._ev is None:
            self.dur = time.perf_counter() - self._t0
            self._emit(bus)
            return
        import torch
        self._ev[1].record(torch.cuda.current_stream(self.device))
        with bus._lock:
            bus.pending.append(self)
            full = len(bus.pending) >= MAX_PENDING
        if full and not torch.cuda.is_current_stream_capturing():
            flush()

    def _resolve(self, bus: "_Bus") -> None:
        """A device span's record, once its end event can be read."""
        start, end = self._ev
        end.synchronize()
        self.dur = start.elapsed_time(end) / 1e3
        self.attrs["clock"] = "cuda_event"
        self._emit(bus)

    def _emit(self, bus: "_Bus") -> None:
        if self.close_attrs is not None:
            self.attrs.update(self.close_attrs(self.dur))
        bus.emit({"kind": "span", "name": self.name, "ts": self.ts,
                  "dur": self.dur, "id": self.id, "parent": self.parent,
                  "attrs": self.attrs})


class _NoopSpan:
    """Shared inert span for the disabled path: no allocation per call."""

    __slots__ = ()
    dur = None
    attrs: dict = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NOOP_SPAN = _NoopSpan()


# ---------------------------------------------------------------------------
# Public hooks: every one starts with the `_BUS is None` fast path
# ---------------------------------------------------------------------------


def enabled() -> bool:
    """True when a telemetry sink is open (``enable`` or
    ``REPRO_TORCH_TELEMETRY=1``)."""
    return _BUS is not None


def enable(path: str | None = None) -> str:
    """Open a JSONL telemetry sink (appending) and turn every hook live.
    Re-enabling with a different path closes the previous sink first.
    Returns the resolved path."""
    global _BUS
    path = path or os.environ.get(ENV_TELEMETRY_PATH) or DEFAULT_PATH
    if _BUS is not None:
        if os.path.abspath(_BUS.path) == os.path.abspath(path):
            return _BUS.path
        disable()
    _BUS = _Bus(path)
    return path


def disable() -> None:
    """Write the pending device spans, close the sink; every hook reverts
    to its no-op fast path."""
    global _BUS
    if _BUS is not None:
        flush()
        _BUS.close()
        _BUS = None


def flush() -> None:
    """Write every pending device span, waiting for its end event (no
    wait once the caller has synchronized the device)."""
    bus = _BUS
    if bus is None or not bus.pending:
        return
    with bus._lock:
        pending, bus.pending = bus.pending, []
    for sp in pending:
        sp._resolve(bus)


def log_path() -> str | None:
    return _BUS.path if _BUS is not None else None


def span(name: str, close_attrs: Callable[[float], dict] | None = None,
         **attrs):
    """Context manager timing a region on the host clock; nests through a
    thread-local stack."""
    if _BUS is None:
        return NOOP_SPAN
    return Span(name, attrs, close_attrs)


def device_span(name: str, device,
                close_attrs: Callable[[float], dict] | None = None,
                **attrs):
    """``span`` for work enqueued on ``device`` (a ``torch.device``): on a
    CUDA device timed by two events on its current stream and written at
    the next :func:`flush`; a ``.trace`` event while the stream captures
    a graph; on the CPU a host-clock span."""
    if _BUS is None:
        return NOOP_SPAN
    return Span(name, attrs, close_attrs,
                device if device.type == "cuda" else None)


def span_event(name: str, dur: float, **attrs) -> None:
    """A span whose duration the caller measured; parented under the
    current open span, stamped as ending now."""
    bus = _BUS
    if bus is None:
        return
    st = bus.stack()
    bus.emit({"kind": "span", "name": name, "ts": max(0.0, bus.now() - dur),
              "dur": float(dur), "id": next(bus._ids),
              "parent": st[-1] if st else None, "attrs": attrs})


def counter(name: str, value: float = 1, **attrs) -> None:
    bus = _BUS
    if bus is None:
        return
    with bus._lock:
        total = bus.totals[name] = bus.totals.get(name, 0) + value
    bus.emit({"kind": "counter", "name": name, "ts": bus.now(),
              "value": value, "total": total, "attrs": attrs})


def gauge(name: str, value: float, **attrs) -> None:
    bus = _BUS
    if bus is None:
        return
    bus.emit({"kind": "gauge", "name": name, "ts": bus.now(),
              "value": float(value), "attrs": attrs})


def event(name: str, **attrs) -> None:
    bus = _BUS
    if bus is None:
        return
    bus.emit({"kind": "event", "name": name, "ts": bus.now(), "attrs": attrs})


def counters() -> dict[str, float]:
    """Snapshot of the in-process counter totals ({} while disabled)."""
    return dict(_BUS.totals) if _BUS is not None else {}


def _env_enable() -> None:
    """Honour ``REPRO_TORCH_TELEMETRY=1`` at import time (how a launcher
    run under the variable starts logging without code changes)."""
    if os.environ.get(ENV_TELEMETRY) == "1" and _BUS is None:
        enable()
