"""Fault injection for elastic-training drills (counterpart of
``repro/runtime/faults.py``; the same grammar, errors and injector).

A fleet that trains for real loses devices mid-run; this module lets a
few ranks *rehearse* that without a card dying.  The injector is
scripted: faults are scheduled against step indices, and the supervisor
in ``launch/train.py`` consumes them at step boundaries, so every drill
is deterministic and replayable.  Every rank polls its own injector with
the same schedule, so the ranks agree on each fault without a message.

A "device" here is a **launch rank**: the rank a process had in
generation 0 of the run.  It is the one identity that survives a
regroup, where the survivors are ranked anew.

  * ``device_loss``: n ranks drop out of the healthy set.  The
    supervisor's current step is tainted (a real loss surfaces as a
    collective error at the next sync point, about one step later), the
    (data, model) layout is re-planned over the survivors, and the
    state is restored from the last committed checkpoint.
  * ``straggle``: one data shard runs ``factor`` x slow from a given
    step onward (its ranks sleep after each step); the supervisor
    rotates the shard's ranks out once the ``ShardStragglerMonitor``
    trips REPLACE.
  * ``preempt``: the scheduler reclaims the node, as the SIGTERM that
    ``PreemptionGuard`` handles: the run drains (flushes a checkpoint
    and stops).

Spec grammar (comma-separated)::

    device_loss@STEP:N        lose N ranks at step STEP
    straggle@STEP:SHARDxF     shard SHARD runs F x slow from step STEP
    preempt@STEP              deliver a preemption at step STEP

    >>> [f.kind for f in parse_faults("device_loss@5:4,preempt@9")]
    ['device_loss', 'preempt']
    >>> parse_faults("straggle@4:1x3")[0].factor
    3.0

Each fault fires exactly once: after a recovery restores to an earlier
step, re-running the fault's step index does NOT re-fire it (the rank
already died; the drill measures recovery, not a crash loop).
"""
from __future__ import annotations

import dataclasses


class DeviceLossError(RuntimeError):
    """An injected device loss, as the supervisor's step path would see
    it: the simulated counterpart of a collective error on real
    hardware."""


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str                 # 'device_loss' | 'straggle' | 'preempt'
    step: int                 # fires at the start of this step
    n_devices: int = 0        # device_loss: how many devices die
    shard: int = 0            # straggle: which data shard slows down
    factor: float = 1.0       # straggle: step-time multiplier


def parse_faults(spec: str) -> list["Fault"]:
    """Parse the CLI fault grammar; raises ValueError with the offending
    token on malformed specs."""
    faults = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        try:
            kind, _, rest = tok.partition("@")
            if kind == "device_loss":
                step, _, n = rest.partition(":")
                faults.append(Fault("device_loss", int(step),
                                    n_devices=int(n or 1)))
            elif kind == "straggle":
                step, _, sf = rest.partition(":")
                shard, _, factor = sf.partition("x")
                faults.append(Fault("straggle", int(step),
                                    shard=int(shard or 0),
                                    factor=float(factor or 2.0)))
            elif kind == "preempt":
                faults.append(Fault("preempt", int(rest)))
            else:
                raise ValueError(f"unknown fault kind {kind!r}")
        except (ValueError, TypeError) as e:
            raise ValueError(
                f"bad fault spec {tok!r} (grammar: device_loss@STEP:N, "
                f"straggle@STEP:SHARDxFACTOR, preempt@STEP): {e}") from None
    return sorted(faults, key=lambda f: f.step)


class FaultInjector:
    """Deterministic fault scheduler over a fixed set of launch ranks.

    The supervisor polls once per step; a fault whose step has been
    reached (and that has not fired yet) is returned exactly once.
    Device losses pick the HIGHEST surviving launch ranks (the layout
    packs shards from the front, so losing the tail exercises a clean
    shrink, and launch rank 0, which writes the checkpoints, stays).
    ``devices`` are ints, or objects with an ``id``.
    """

    def __init__(self, faults, devices):
        self.faults = sorted(faults, key=lambda f: f.step)
        self._device_ids = [getattr(d, "id", d) for d in devices]
        self._lost: set[int] = set()
        self._fired: set[int] = set()
        self._straggle: Fault | None = None
        self._straggle_since: float | None = None

    # -- supervisor interface ------------------------------------------------

    def poll(self, step: int) -> Fault | None:
        """The first not-yet-fired fault with fault.step <= step, or None.
        Marks it fired: restored-and-replayed steps never re-fire it."""
        for idx, f in enumerate(self.faults):
            if idx in self._fired or f.step > step:
                continue
            self._fired.add(idx)
            return f
        return None

    def commit_loss(self, fault: Fault) -> set[int]:
        """Consume a device_loss fault: marks the victims lost and returns
        their launch ranks."""
        survivors = [i for i in self._device_ids if i not in self._lost]
        victims = set(survivors[-fault.n_devices:])
        self._lost |= victims
        return victims

    def mark_lost(self, ids) -> None:
        """Externally-decided rotation (e.g. straggler REPLACE): the
        supervisor names the launch ranks leaving the layout."""
        self._lost |= set(ids)

    def lost(self) -> set[int]:
        return set(self._lost)

    def healthy(self):
        """Surviving launch ranks, in launch order."""
        return [i for i in self._device_ids if i not in self._lost]

    # -- straggler simulation ------------------------------------------------

    def begin_straggle(self, fault: Fault, now: float) -> None:
        self._straggle = fault
        self._straggle_since = now

    def straggle_active(self) -> Fault | None:
        return self._straggle

    def straggle_onset(self) -> float | None:
        """Monotonic time the active straggle began (time-to-detect runs
        from here to the monitor's REPLACE verdict)."""
        return self._straggle_since

    def end_straggle(self) -> None:
        self._straggle = None
        self._straggle_since = None
