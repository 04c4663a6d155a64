"""Structured event bus: the one stream the dependability layers emit
into (docs/observability.md).

``EventBus`` is a thread-safe bounded ring buffer of ``Event`` records.
Producers — the heartbeat monitor, the fault injector and the serving
engine in this slice — call ``emit(subsystem, kind, **data)``; the bus
stamps a monotonic timestamp (``t_mono``) and a wall-clock one
(``t_wall``), assigns a global sequence number, and appends.  Consumers
poll (``events()``) or subscribe (``subscribe(fn)``: the callback runs on
the emitting thread, outside the bus lock).

The ring is bounded (``DEFAULT_CAPACITY``): under sustained traffic old
events fall off the front and ``dropped`` counts them.  The JSONL sink of
the reference bus waits for the observability slice.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

DEFAULT_CAPACITY = 10_000

#: payload keys that would collide with Event's own fields when the
#: event is flattened to one record — rejected up front
RESERVED_KEYS = frozenset({"seq", "t_mono", "t_wall", "subsystem",
                           "kind"})


@dataclasses.dataclass(frozen=True)
class Event:
    """One structured event; ``data`` carries the subsystem payload."""
    seq: int
    t_mono: float          # time.perf_counter() at emit — ordering/latency
    t_wall: float          # time.time() at emit — external correlation
    subsystem: str
    kind: str
    data: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        return {"seq": self.seq, "t_mono": self.t_mono,
                "t_wall": self.t_wall, "subsystem": self.subsystem,
                "kind": self.kind, **self.data}


class EventBus:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped = 0
        self._subscribers: List[Callable[[Event], None]] = []

    def emit(self, subsystem: str, kind: str, **data: Any) -> Event:
        bad = RESERVED_KEYS & data.keys()
        if bad:
            raise ValueError(
                f"event payload keys {sorted(bad)} collide with Event "
                f"fields; rename them (e.g. kind -> save_kind)")
        with self._lock:
            ev = Event(seq=self._seq, t_mono=time.perf_counter(),
                       t_wall=time.time(), subsystem=subsystem, kind=kind,
                       data=data)
            self._seq += 1
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(ev)
            subscribers = list(self._subscribers)
        # callbacks OUTSIDE the lock: a subscriber may emit (re-entrancy)
        # or inspect the bus without deadlocking
        for fn in subscribers:
            fn(ev)
        return ev

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
        with self._lock:
            self._subscribers.append(fn)
        return fn

    def unsubscribe(self, fn: Callable[[Event], None]) -> None:
        with self._lock:
            if fn in self._subscribers:
                self._subscribers.remove(fn)
