"""Fault injection (fail-stop, straggle, bit-flips, the serving events)
and the straggler watchdog.

``FaultInjector`` carries the training and serving events of the
reference's injector.  Training: a scheduled fail-stop raises
``SimulatedFailure`` at a step boundary (the process "dies"); the harness
then restarts from the last checkpoint exactly like a scheduler would
relaunch the job; a straggle sleeps inside the superstep; a scheduled
bit-flip (``schedule_bitflip``, applied by ``apply_sdc``) flips one bit
inside a named state leaf, and the run goes on with a wrong answer until
an SDC tier notices.  Serving: a scheduled replica kill raises
``SimulatedFailure`` the first time the replica is dispatched to at or
past its step, a scheduled replica SDC raises ``CorruptionDetected`` (the
engine takes the sentinel path), and a latency spike sleeps before the
replica's work.

``CorruptionDetected`` is the signal the SDC tiers raise; the recovery
loop treats it as a failure whose cure is rollback.

``StragglerWatchdog`` tracks step durations and flags steps slower than
``factor`` x the running median.
"""
from __future__ import annotations

import math
import statistics
import time
from collections import deque
from typing import Deque, Dict, List, Tuple

import numpy as np
import torch


class SimulatedFailure(RuntimeError):
    def __init__(self, step: int, host_id: int = 0, kind: str = "fail-stop"):
        super().__init__(f"{kind} at step {step} on host {host_id}")
        self.step = step
        self.host_id = host_id
        self.kind = kind


class CorruptionDetected(RuntimeError):
    """An SDC tier found corrupted state/output.  ``kind``: "scrub" (tier
    2, ``detail`` names the corrupted leaves), "sentinel" (tier 3,
    ``detail`` is the trip reason); serving raises it from the decode
    sentinel or an injected replica SDC."""

    def __init__(self, step: int, kind: str, detail: str = ""):
        super().__init__(f"corruption detected at step {step} "
                         f"[{kind}] {detail}")
        self.step = step
        self.kind = kind
        self.detail = detail


def flip_bit(leaf, bit: int):
    """A copy of ``leaf`` with absolute ``bit`` of its buffer flipped
    (``bit // 8`` is the byte offset in ``reshape(-1)`` order, the bit
    little-endian within the byte), on the leaf's device; a numpy leaf
    gives a numpy copy."""
    if isinstance(leaf, torch.Tensor):
        out = leaf.detach().clone().contiguous()
        flat = out.reshape(-1).view(torch.uint8)     # aliases out
        if not 0 <= bit < flat.numel() * 8:
            raise IndexError(f"bit {bit} out of range for "
                             f"{flat.numel()}-byte leaf")
        flat[bit // 8] ^= 1 << (bit % 8)
        return out
    arr = np.array(leaf)                     # writable, contiguous copy
    flat = arr.reshape(-1).view(np.uint8)    # aliases arr's buffer
    if not 0 <= bit < flat.size * 8:
        raise IndexError(f"bit {bit} out of range for {flat.size}-byte leaf")
    flat[bit // 8] ^= np.uint8(1 << (bit % 8))
    return arr


def flip_shard_bit(shard, bit: int, shape, spans):
    """``shard`` (a rank's piece of a leaf of global ``shape``, ``spans``
    its ``[start, stop)`` per dim) with absolute ``bit`` of the GLOBAL
    leaf flipped where the shard holds that byte (``flip_bit``'s byte
    order over the whole leaf), else ``shard`` itself."""
    size = shard.element_size()
    total = math.prod(int(n) for n in shape) * size
    if not 0 <= bit < total * 8:
        raise IndexError(f"bit {bit} out of range for {total}-byte leaf")
    elem, byte = divmod(bit // 8, size)
    idx = np.unravel_index(elem, tuple(int(n) for n in shape))
    if not all(a <= i < b for i, (a, b) in zip(idx, spans)):
        return shard
    local = np.ravel_multi_index(
        tuple(int(i) - a for i, (a, _) in zip(idx, spans)),
        tuple(shard.shape))
    return flip_bit(shard, (int(local) * size + byte) * 8 + bit % 8)


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
        self.sdc_injected: List[Tuple[int, str, int]] = []  # (step, leaf, bit)
        # telemetry: fired injections land on the bus as ground truth to
        # hold the detectors' events against (injected vs detected)
        self.obs = obs
        # on a rank mesh: () -> (global template tree, shardings tree) of
        # the state, so that a flip lands only in the shards holding its
        # byte of the global leaf (``flip_shard_bit``)
        self.layout = None

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

    def schedule_bitflip(self, step: int, leaf: str, bit: int) -> int:
        """Flip ``bit`` of state leaf ``leaf`` (dotted name, the checkpoint
        manifest's: e.g. "params.blocks.l0.mlp.w_in") just before
        superstep ``step`` executes."""
        return self._add("bitflip", step, leaf=leaf, bit=int(bit))

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

    def apply_sdc(self, step: int, state):
        """``state`` with any bit-flips scheduled for ``step`` applied (the
        identity when none are due).  Unlike ``check`` this corrupts
        silently: nothing raises."""
        flips = [ev for ev in self._match("bitflip") if ev["step"] == step]
        if not flips:
            return state
        from repro_torch.tree import flatten_named, unflatten

        named = flatten_named(state)
        names = [n for n, _ in named]
        leaves = [v for _, v in named]
        placed = {}                          # name -> (global shape, sharding)
        template, shardings = (self.layout() if self.layout is not None
                               else (None, None))
        if shardings is not None:
            by_name = dict(flatten_named(shardings))
            placed = {n: (tuple(g.shape), by_name.get(n))
                      for n, g in flatten_named(template)}
        for ev in flips:
            del self._events[ev["id"]]
            leaf_name, bit = ev["leaf"], ev["bit"]
            if leaf_name not in names:
                raise KeyError(f"no state leaf {leaf_name!r}; have "
                               f"{names[:8]}...")
            i = names.index(leaf_name)
            shape, sh = placed.get(leaf_name, (None, None))
            if sh is None or not shape:
                leaves[i] = flip_bit(leaves[i], bit)
            else:
                leaves[i] = flip_shard_bit(leaves[i], bit, shape,
                                           sh.spans(shape))
            self.sdc_injected.append((step, leaf_name, bit))
            self._emit("bitflip", step=step, leaf=leaf_name, bit=bit)
        return unflatten(state, leaves)


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
