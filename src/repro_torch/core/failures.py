"""Fault injection (fail-stop, straggle, the serving events) and the
straggler watchdog.

``FaultInjector`` carries the training and serving events of the
reference's injector.  Training: a scheduled fail-stop raises
``SimulatedFailure`` at a step boundary (the process "dies"); the harness
then restarts from the last checkpoint exactly like a scheduler would
relaunch the job; a straggle sleeps inside the superstep.  Serving: a
scheduled replica kill raises ``SimulatedFailure`` the first time the
replica is dispatched to at or past its step, a scheduled replica SDC
raises ``CorruptionDetected`` (the engine takes the sentinel path), and a
latency spike sleeps before the replica's work.  Scheduled bit-flips
(``schedule_bitflip``/``apply_sdc``) wait for the SDC slice of the port
(ROADMAP item 5).

``CorruptionDetected`` is the signal the SDC tiers raise.

``StragglerWatchdog`` tracks step durations and flags steps slower than
``factor`` x the running median.
"""
from __future__ import annotations

import statistics
import time
from collections import deque
from typing import Deque, Dict, List, Tuple


class SimulatedFailure(RuntimeError):
    def __init__(self, step: int, host_id: int = 0, kind: str = "fail-stop"):
        super().__init__(f"{kind} at step {step} on host {host_id}")
        self.step = step
        self.host_id = host_id
        self.kind = kind


class CorruptionDetected(RuntimeError):
    """An SDC tier found corrupted state/output (serving: the decode
    sentinel, or an injected replica SDC).  ``detail`` is the reason."""

    def __init__(self, step: int, kind: str, detail: str = ""):
        super().__init__(f"corruption detected at step {step} "
                         f"[{kind}] {detail}")
        self.step = step
        self.kind = kind
        self.detail = detail


class FaultInjector:
    """Deterministic fault scheduler for the serving tests and drivers.

    Every ``schedule_*`` call returns an integer event id; pending events
    are inspectable (``pending``), cancellable (``cancel``), and bulk-
    clearable (``reset``).  Duplicate schedules at the same step are kept
    as distinct events (two replica kills at one engine step model a
    correlated rack loss)."""

    def __init__(self, obs=None):
        self._events: Dict[int, Dict] = {}    # eid -> event record
        self._next_eid = 0
        self.triggered: List[int] = []
        self.replica_kills: List[Tuple[int, int]] = []   # (step, replica)
        # telemetry: fired injections land on the bus as ground truth to
        # hold the detectors' events against (injected vs detected)
        self.obs = obs

    def _emit(self, kind: str, **data) -> None:
        if self.obs is not None:
            self.obs.emit("injector", kind, **data)

    # ------------------------------------------------------------------
    # event bookkeeping
    # ------------------------------------------------------------------
    def _add(self, kind: str, step: int, **args) -> int:
        eid = self._next_eid
        self._next_eid += 1
        self._events[eid] = {"id": eid, "kind": kind, "step": int(step),
                             **args}
        return eid

    def _match(self, kind: str):
        """Pending events of ``kind`` in deterministic (step, id) order."""
        return sorted((e for e in self._events.values()
                       if e["kind"] == kind),
                      key=lambda e: (e["step"], e["id"]))

    def pending(self) -> List[Dict]:
        """Snapshot of every not-yet-fired event, (step, id)-ordered."""
        return sorted((dict(e) for e in self._events.values()),
                      key=lambda e: (e["step"], e["id"]))

    def cancel(self, event_id: int) -> bool:
        """Remove one pending event; False if it already fired/was
        cancelled."""
        return self._events.pop(event_id, None) is not None

    def reset(self) -> None:
        """Drop every pending event (fired-event logs are kept)."""
        self._events.clear()

    # ------------------------------------------------------------------
    # scheduling (each returns the event id)
    # ------------------------------------------------------------------
    def schedule_failstop(self, step: int, host_id: int = 0) -> int:
        return self._add("failstop", step, host=host_id)

    def schedule_straggle(self, step: int, extra_seconds: float) -> int:
        return self._add("straggle", step, extra=float(extra_seconds))

    def schedule_replica_kill(self, step: int, replica_id: int = 0) -> int:
        """Kill serving replica ``replica_id`` at engine step ``step``:
        ``check_replica`` raises ``SimulatedFailure(kind="replica-kill")``
        the first time that replica is dispatched to at or past the step."""
        return self._add("replica-kill", step, replica=replica_id)

    def schedule_latency_spike(self, step: int, extra_seconds: float,
                               replica_id=None) -> int:
        """At engine step ``step`` the dispatched replica (or only
        ``replica_id`` when given) sleeps ``extra_seconds`` before its
        work."""
        return self._add("latency-spike", step, replica=replica_id,
                         extra=float(extra_seconds))

    def schedule_replica_sdc(self, step: int, replica_id: int = 0,
                             detail: str = "injected") -> int:
        """Corrupt serving replica ``replica_id`` at or past engine step
        ``step``: ``check_replica`` raises ``CorruptionDetected`` the next
        time the replica is dispatched to."""
        return self._add("replica-sdc", step, replica=replica_id,
                         detail=detail)

    # ------------------------------------------------------------------
    # firing
    # ------------------------------------------------------------------
    def check_replica(self, step: int, replica_id: int):
        """Call before dispatching work to a replica at an engine step."""
        for ev in self._match("latency-spike"):
            if ev["step"] == step and (ev["replica"] is None
                                       or ev["replica"] == replica_id):
                del self._events[ev["id"]]
                time.sleep(ev["extra"])
                break
        for ev in self._match("replica-sdc"):
            if step >= ev["step"] and ev["replica"] == replica_id:
                del self._events[ev["id"]]
                self._emit("replica_sdc", step=step, replica=replica_id,
                           detail=ev["detail"])
                raise CorruptionDetected(step, "injected-sdc",
                                         ev["detail"])
        for ev in self._match("replica-kill"):
            # ">= step": the victim may not be dispatched at the exact step
            # (empty pool, already draining) — the kill must still land
            if step >= ev["step"] and ev["replica"] == replica_id:
                del self._events[ev["id"]]
                self.replica_kills.append((step, replica_id))
                self._emit("replica_kill", step=step, replica=replica_id)
                raise SimulatedFailure(step, replica_id, kind="replica-kill")

    def check(self, step: int):
        """Call at each BSP step boundary."""
        for ev in self._match("straggle"):
            if ev["step"] == step:
                del self._events[ev["id"]]
                self._emit("straggle", step=step, extra=ev["extra"])
                time.sleep(ev["extra"])
        for ev in self._match("failstop"):
            if ev["step"] == step:
                del self._events[ev["id"]]
                self.triggered.append(step)
                self._emit("failstop", step=step, host=ev["host"])
                raise SimulatedFailure(step, ev["host"])


class StragglerWatchdog:
    def __init__(self, factor: float = 3.0, window: int = 32,
                 min_samples: int = 5):
        self.factor = factor
        self.window = window
        self.min_samples = min_samples
        # bounded at exactly ``window`` samples: the median only ever
        # looks at the newest window
        self.durations: Deque[float] = deque(maxlen=window)
        self.flagged_steps: List[int] = []

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self.durations) >= self.min_samples:
            med = statistics.median(self.durations)
            if seconds > self.factor * med:
                is_straggler = True
                self.flagged_steps.append(step)
                # keep the newest 4x window flags, not every flag
                if len(self.flagged_steps) > 4 * self.window:
                    del self.flagged_steps[:-2 * self.window]
        self.durations.append(seconds)
        return is_straggler
