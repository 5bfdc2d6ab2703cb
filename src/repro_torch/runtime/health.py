"""Step-level health monitoring (counterpart of
``repro/runtime/health.py``; the same verdicts and rollup).

The in-step half of fault tolerance lives in ``train_step`` (the
non-finite guard: the update is skipped, not crashed).  This module is
the host-side half:

  * ``HealthMonitor`` — tracks consecutive skipped steps and loss spikes;
    escalates from WARN to RESTORE when the run is diverging (a corrupted
    batch or a bad host), on which the launcher restores the newest
    checkpoint.
  * ``PreemptionGuard`` — a SIGTERM handler that asks the training loop
    to flush a checkpoint and stop before the scheduler reclaims the
    node.
"""
from __future__ import annotations

import signal
import threading
from dataclasses import dataclass, field


@dataclass
class HealthMonitor:
    max_consecutive_skips: int = 5
    loss_spike_factor: float = 10.0
    ema_decay: float = 0.98
    _skips: int = 0
    _loss_ema: float | None = None
    events: list = field(default_factory=list)

    def record(self, step: int, loss: float, skipped: bool) -> str:
        """Returns 'ok' | 'warn' | 'restore'."""
        if skipped:
            self._skips += 1
            self.events.append((step, "skip"))
            if self._skips >= self.max_consecutive_skips:
                self.events.append((step, "restore: non-finite streak"))
                return "restore"
            return "warn"
        self._skips = 0
        if (self._loss_ema is not None
                and loss > self.loss_spike_factor * self._loss_ema):
            self.events.append((step, f"warn: loss spike {loss:.3g} vs ema "
                                      f"{self._loss_ema:.3g}"))
            self._loss_ema = (self.ema_decay * self._loss_ema
                              + (1 - self.ema_decay) * loss)
            return "warn"
        self._loss_ema = (loss if self._loss_ema is None else
                          self.ema_decay * self._loss_ema
                          + (1 - self.ema_decay) * loss)
        return "ok"

    def rollup(self) -> dict:
        """JSON-safe summary for a ``train.health.rollup`` telemetry event:
        the event log sliced by type, plus the current loss EWMA."""
        kinds: dict[str, int] = {}
        for _, what in self.events:
            kinds[what.split(":")[0]] = kinds.get(what.split(":")[0], 0) + 1
        return {
            "events": len(self.events),
            "by_kind": kinds,
            "consecutive_skips": self._skips,
            "loss_ema": self._loss_ema,
        }


class PreemptionGuard:
    """SIGTERM -> set a flag the training loop polls; the loop then saves a
    checkpoint and stops instead of being killed mid-write.
    :meth:`close` puts the previous handler back."""

    def __init__(self, install: bool = True):
        self._requested = threading.Event()
        self._previous = None
        if install:
            try:
                self._previous = signal.signal(signal.SIGTERM, self._handler)
            except ValueError:  # not on the main thread
                pass

    def _handler(self, signum, frame):
        self._requested.set()

    def preempted(self) -> bool:
        return self._requested.is_set()

    def request(self) -> None:  # for tests and a manual drain
        self._requested.set()

    def close(self) -> None:
        if self._previous is not None:
            signal.signal(signal.SIGTERM, self._previous)
            self._previous = None
