"""Dependability telemetry for the serving slice: the event bus and the
metrics registry behind one handle every layer shares.

Timelines, exports and scenario reconstruction wait for the
observability slice; the serving engine's core path does not call them.
"""
from __future__ import annotations

from typing import Any, List, Optional

from repro_torch.obs.bus import DEFAULT_CAPACITY, Event, EventBus
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)

__all__ = ["Observability", "EventBus", "Event", "DEFAULT_CAPACITY",
           "MetricsRegistry", "Counter", "Gauge", "Histogram"]


class Observability:
    """Event bus + metrics registry, one per deployment (process)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.bus = EventBus(capacity=capacity)
        self.registry = MetricsRegistry()

    def emit(self, subsystem: str, kind: str, **data: Any) -> Event:
        return self.bus.emit(subsystem, kind, **data)

    def events(self, subsystem: Optional[str] = None,
               kind: Optional[str] = None) -> List[Event]:
        return self.bus.events(subsystem=subsystem, kind=kind)

    def close(self) -> None:
        """Nothing is held open in this slice (no JSONL sink); kept so
        callers close the handle the same way as the reference's."""
