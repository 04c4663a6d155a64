"""Structured event bus: the one stream every dependability layer emits
into (docs/observability.md); the reference's ``obs/bus.py``.

``EventBus`` is a thread-safe bounded ring buffer of ``Event`` records.
Producers — the heartbeat monitor, the facade's saves and restores, the
SDC tiers, the BSP loop, the serving engine and the fault injector —
call ``emit(subsystem, kind, **data)``; the bus stamps both a monotonic
timestamp (``t_mono``, ``time.perf_counter()``: ordering and latency
math, the same clock as the reference's) and a wall-clock one
(``t_wall``, for correlating with external logs), assigns a global
sequence number, and appends.  Consumers either poll (``events()``
returns a snapshot) or subscribe (``subscribe(fn)`` — the callback runs
on the *emitting* thread, outside the bus lock, so a slow subscriber
delays its producer but can never deadlock the bus).  Payloads are
JSON-ready Python scalars, lists and dicts: the JSONL sink writes them
as they are.

The ring is bounded (default ``DEFAULT_CAPACITY`` = the serving layer's
10k observability cap): under sustained traffic old events fall off the
front and ``dropped`` counts them.

A JSONL sink (``attach_jsonl``) persists every event as one JSON line at
emit time — the durable record ``repro_torch.obs.export.to_scenario``
converts back into a chaos ``Scenario`` (record-and-replay).  The sink
is size-bounded the same way the ring is count-bounded: past
``max_bytes`` the live file rotates to ``<path>.1..N`` (ascending =
chronological) and at most ``max_segments`` rotated segments are kept.
``load_jsonl`` reads the rotated segments in order, then the live file,
so replay sees one continuous stream.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

#: ring-buffer bound, shared convention with serve.scheduler's
#: OBSERVABILITY_CAP (the serving engine asserts its .events back-compat
#: view stays under this via the bus)
DEFAULT_CAPACITY = 10_000

#: payload keys that would collide with Event's own fields when the
#: event is flattened to one JSON object (to_dict / the JSONL sink) —
#: emit rejects them up front so the collision is an immediate error,
#: not a silently corrupted log
RESERVED_KEYS = frozenset({"seq", "t_mono", "t_wall", "subsystem",
                           "kind"})


@dataclasses.dataclass(frozen=True)
class Event:
    """One structured event.  ``data`` carries the subsystem-specific
    payload (host/replica/step/leaf ids, durations, byte counts...)."""
    seq: int
    t_mono: float          # time.perf_counter() at emit — ordering/latency
    t_wall: float          # time.time() at emit — external correlation
    subsystem: str         # "heartbeat" | "checkpoint" | "sdc" | ...
    kind: str              # subsystem-specific event name
    data: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        return {"seq": self.seq, "t_mono": self.t_mono,
                "t_wall": self.t_wall, "subsystem": self.subsystem,
                "kind": self.kind, **self.data}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Event":
        d = dict(d)
        return cls(seq=int(d.pop("seq", 0)),
                   t_mono=float(d.pop("t_mono", 0.0)),
                   t_wall=float(d.pop("t_wall", 0.0)),
                   subsystem=str(d.pop("subsystem", "")),
                   kind=str(d.pop("kind", "")), data=d)


class EventBus:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped = 0                   # events evicted off the ring
        self._subscribers: List[Callable[[Event], None]] = []
        self._jsonl: Optional[io.TextIOBase] = None
        self._jsonl_path: Optional[str] = None
        self._jsonl_max_bytes: Optional[int] = None
        self._jsonl_max_segments = 8
        self._jsonl_bytes = 0
        self._jsonl_indices: List[int] = []   # live rotated-segment indices

    # ------------------------------------------------------------------
    # producing
    # ------------------------------------------------------------------
    def emit(self, subsystem: str, kind: str, **data: Any) -> Event:
        bad = RESERVED_KEYS & data.keys()
        if bad:
            raise ValueError(
                f"event payload keys {sorted(bad)} collide with Event "
                f"fields; rename them (e.g. kind -> save_kind)")
        ev = Event(seq=0, t_mono=time.perf_counter(), t_wall=time.time(),
                   subsystem=subsystem, kind=kind, data=data)
        with self._lock:
            ev = dataclasses.replace(ev, seq=self._seq)
            self._seq += 1
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(ev)
            subscribers = list(self._subscribers)
            # sink write INSIDE the lock: rotation (close + rename + reopen)
            # must be atomic against concurrent emitters
            if self._jsonl is not None:
                try:
                    self._sink_write(json.dumps(ev.to_dict()) + "\n")
                except ValueError:
                    pass                   # sink closed under the emitter
        # callbacks OUTSIDE the lock: a subscriber may emit (re-entrancy)
        # or inspect the bus without deadlocking
        for fn in subscribers:
            fn(ev)
        return ev

    # ------------------------------------------------------------------
    # consuming
    # ------------------------------------------------------------------
    def events(self, subsystem: Optional[str] = None,
               kind: Optional[str] = None) -> List[Event]:
        """Snapshot of the retained ring, oldest first, optionally
        filtered."""
        with self._lock:
            evs = list(self._ring)
        return [e for e in evs
                if (subsystem is None or e.subsystem == subsystem)
                and (kind is None or e.kind == kind)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def total_emitted(self) -> int:
        with self._lock:
            return self._seq

    def subscribe(self, fn: Callable[[Event], None]) -> Callable:
        """Register a hook invoked (on the emitting thread) for every
        subsequent event; returns ``fn`` so it can be unsubscribed."""
        with self._lock:
            self._subscribers.append(fn)
        return fn

    def unsubscribe(self, fn: Callable[[Event], None]) -> None:
        with self._lock:
            if fn in self._subscribers:
                self._subscribers.remove(fn)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # ------------------------------------------------------------------
    # JSONL sink (record side of record-and-replay)
    # ------------------------------------------------------------------
    def attach_jsonl(self, path: str, max_bytes: Optional[int] = None,
                     max_segments: int = 8) -> str:
        """Persist every subsequent event as one JSON line at ``path``
        (append mode: re-attaching resumes the log).

        ``max_bytes`` bounds the LIVE file: a write that would push it
        past the cap first rotates it to ``<path>.<i>`` (``i`` ascending,
        so ``.1`` is the oldest segment) and keeps at most
        ``max_segments`` rotated segments, deleting older ones — total
        disk is bounded by ~``(max_segments + 1) * max_bytes``.
        ``max_bytes=None`` (default) keeps the unbounded legacy
        behaviour."""
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
            self._jsonl = open(path, "a")
            self._jsonl_path = path
            self._jsonl_max_bytes = max_bytes
            self._jsonl_max_segments = max(int(max_segments), 1)
            self._jsonl_bytes = self._jsonl.tell()
            self._jsonl_indices = _segment_indices(path)
        return path

    def _sink_write(self, line: str) -> None:
        """Write one line to the sink, rotating first if it would push
        the live file past ``max_bytes``.  Caller holds the lock."""
        if (self._jsonl_max_bytes is not None and self._jsonl_bytes > 0
                and self._jsonl_bytes + len(line) > self._jsonl_max_bytes):
            self._rotate_locked()
        self._jsonl.write(line)
        self._jsonl_bytes += len(line)

    def _rotate_locked(self) -> None:
        self._jsonl.close()
        idx = (self._jsonl_indices[-1] + 1) if self._jsonl_indices else 1
        os.replace(self._jsonl_path, f"{self._jsonl_path}.{idx}")
        self._jsonl_indices.append(idx)
        while len(self._jsonl_indices) > self._jsonl_max_segments:
            doomed = self._jsonl_indices.pop(0)
            try:
                os.remove(f"{self._jsonl_path}.{doomed}")
            except FileNotFoundError:
                pass
        self._jsonl = open(self._jsonl_path, "a")
        self._jsonl_bytes = 0

    def flush(self) -> None:
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.flush()

    def close(self) -> None:
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None


def _segment_indices(path: str) -> List[int]:
    """Indices of existing rotated segments ``<path>.<i>``, ascending."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path) + "."
    idxs = []
    try:
        names = os.listdir(d)
    except FileNotFoundError:
        return []
    for name in names:
        if name.startswith(base) and name[len(base):].isdigit():
            idxs.append(int(name[len(base):]))
    return sorted(idxs)


def load_jsonl(path: str) -> List[Event]:
    """Read a recorded event log back (replay side); skips blank lines.

    Rotated segments (``<path>.1..N``, oldest = lowest index) are read
    first, then the live file, so a rotated log replays as one
    continuous stream."""
    out = []
    paths = [f"{path}.{i}" for i in _segment_indices(path)]
    if os.path.exists(path) or not paths:
        paths.append(path)        # missing live file still raises below
    for p in paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(Event.from_dict(json.loads(line)))
    return out
