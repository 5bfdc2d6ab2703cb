"""Straggler detection (counterpart of ``repro/runtime/straggler.py``;
the same detector, verdicts and rollups).

In a synchronous-SPMD fleet every step runs at the speed of the slowest
participant, so stragglers are detected from *step wall-time*, not from
per-host telemetry: a healthy step time is tracked with an EWMA + variance
estimate, and a step slower than ``ewma + threshold·std`` (and at least
``min_ratio×`` the EWMA) is flagged.

What the port's launcher does with it:
  * a ``train.shard.step_time`` gauge per rank and step, and the
    verdict in the step's printed line (always);
  * after ``trip`` consecutive flags the detector recommends REPLACE;
    in a ``--faults`` drill every rank feeds the monitor every data
    shard's time, and on REPLACE the supervisor rotates the straggling
    shard's ranks out of the next generation (``launch/train.py``).

The detector is deliberately stateful-but-tiny: it must never add a
collective of its own to the hot path.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class StragglerDetector:
    ema_decay: float = 0.9
    threshold_std: float = 4.0
    min_ratio: float = 1.5
    trip: int = 3
    warmup: int = 5          # compile/first-touch steps are ignored
    _n: int = 0
    _ema: float = 0.0
    _var: float = 0.0
    _consecutive: int = 0
    flagged_steps: list = field(default_factory=list)

    def record(self, step: int, dt: float) -> str:
        """Feed one step wall-time; returns 'ok' | 'slow' | 'replace'."""
        self._n += 1
        if self._n <= self.warmup:
            self._ema = dt if self._ema == 0 else 0.5 * (self._ema + dt)
            return "ok"
        std = max(self._var, 1e-12) ** 0.5
        slow = (dt > self._ema + self.threshold_std * std
                and dt > self.min_ratio * self._ema)
        if slow:
            self._consecutive += 1
            self.flagged_steps.append((step, dt, self._ema))
            # do NOT fold outliers into the EWMA — they would mask repeats
            return "replace" if self._consecutive >= self.trip else "slow"
        self._consecutive = 0
        d = dt - self._ema
        self._ema += (1 - self.ema_decay) * d
        self._var = self.ema_decay * (self._var + (1 - self.ema_decay) * d * d)
        return "ok"

    @property
    def healthy_step_time(self) -> float:
        return self._ema


@dataclass
class ShardStragglerMonitor:
    """Fleet view over per-shard step times: one ``StragglerDetector`` per
    data-parallel shard, fed either live by the launcher or offline from
    telemetry gauges (``train.shard.step_time`` records emitted by
    ``launch/train.py`` and consumed by ``repro_torch.obs.report``).

    A shard is *a straggler* once its detector has recommended REPLACE at
    least once — the fleet controller uses ``stragglers()`` to pick which
    hosts to rotate out of the next mesh epoch.
    """

    ema_decay: float = 0.9
    threshold_std: float = 4.0
    min_ratio: float = 1.5
    trip: int = 3
    warmup: int = 5
    detectors: dict = field(default_factory=dict)
    _replace: set = field(default_factory=set)

    def _detector(self, shard: int) -> StragglerDetector:
        det = self.detectors.get(shard)
        if det is None:
            det = self.detectors[shard] = StragglerDetector(
                ema_decay=self.ema_decay, threshold_std=self.threshold_std,
                min_ratio=self.min_ratio, trip=self.trip, warmup=self.warmup)
        return det

    def record(self, shard: int, step: int, dt: float) -> str:
        """Feed one (shard, step, wall-time); returns that shard's verdict
        ('ok' | 'slow' | 'replace')."""
        verdict = self._detector(int(shard)).record(step, dt)
        if verdict == "replace":
            self._replace.add(int(shard))
        return verdict

    def feed_gauges(self, events) -> dict[int, str]:
        """Drive detection from telemetry records (the offline path): every
        ``train.shard.step_time`` gauge is replayed in (shard, step) order.
        Returns the final verdict per shard."""
        samples = []
        for r in events:
            if r.get("kind") == "gauge" and r.get("name") == "train.shard.step_time":
                a = r.get("attrs", {})
                samples.append((int(a.get("shard", r.get("pid", 0))),
                                int(a.get("step", -1)), r["value"]))
        last: dict[int, str] = {}
        for shard, step, dt in sorted(samples):
            last[shard] = self.record(shard, step, dt)
        return last

    def stragglers(self) -> set:
        """Shards whose detector has recommended REPLACE."""
        return set(self._replace)

    def rollup(self) -> dict:
        """JSON-safe summary for a ``train.straggler.rollup`` event."""
        return {
            "shards": len(self.detectors),
            "stragglers": sorted(self._replace),
            "flagged": {str(s): len(d.flagged_steps)
                        for s, d in sorted(self.detectors.items())
                        if d.flagged_steps},
            "healthy_step_time": {
                str(s): d.healthy_step_time
                for s, d in sorted(self.detectors.items())},
        }
