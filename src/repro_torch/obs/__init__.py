"""Dependability telemetry: structured events, live metrics, failure
timelines, record-and-replay (docs/observability.md); the reference's
``obs/__init__.py``.

``Observability`` bundles the event bus and the metrics registry behind
one handle that every layer shares::

    obs = Observability(jsonl_path="telemetry/events.jsonl")
    dep.attach_obs(obs)              # training plane
    engine = ServeEngine(..., obs=obs)   # serving plane
    AnomalyEngine().attach(obs.bus)  # precursors -> proactive hooks

    obs.emit("heartbeat", "failure", host=3)
    obs.registry.counter("sdc.detected", tier="abft").inc()

    obs.timeline().summary()         # {"mttr_s": ..., "availability": ...}
    obs.to_scenario()                # recorded log -> replayable Scenario
    obs.dump("out/telemetry")        # events.jsonl + trace.json +
                                     # metrics.json + metrics.prom
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, List, Optional

from repro_torch.obs.agent import TelemetryAgent
from repro_torch.obs.anomaly import (AnomalyEngine, BeatJitterDetector,
                                     ScrubRateDetector,
                                     StepTimeDriftDetector,
                                     make_proactive_hook)
from repro_torch.obs.bus import (DEFAULT_CAPACITY, Event, EventBus,
                                 load_jsonl)
from repro_torch.obs.collector import Collector
from repro_torch.obs.export import (to_chrome_trace, to_scenario,
                                    write_chrome_trace)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, Span)
from repro_torch.obs.timeline import Incident, Timeline

__all__ = [
    "Observability", "EventBus", "Event", "DEFAULT_CAPACITY",
    "load_jsonl", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "Span", "Timeline", "Incident", "to_chrome_trace",
    "write_chrome_trace", "to_scenario", "AnomalyEngine",
    "BeatJitterDetector", "ScrubRateDetector", "StepTimeDriftDetector",
    "make_proactive_hook", "TelemetryAgent", "Collector",
]


class _HostTally:
    """``with obs.timed(): ...`` adds the block's host seconds to
    ``obs.host_seconds``."""
    __slots__ = ("obs", "t0")

    def __init__(self, obs: "Observability"):
        self.obs = obs

    def __enter__(self) -> None:
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        self.obs.host_seconds += time.perf_counter() - self.t0


class Observability:
    """Event bus + metrics registry, one per deployment (process).

    ``host_seconds`` is the instrumentation's own cost on the training
    thread: the BSP loop and the facade time their emits, their metric
    updates and the proactive hook (detectors subscribed to the bus run
    inside the emit) with ``timed()``."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 jsonl_path: Optional[str] = None):
        self.bus = EventBus(capacity=capacity)
        self.registry = MetricsRegistry()
        self.host_seconds = 0.0
        if jsonl_path is not None:
            self.bus.attach_jsonl(jsonl_path)

    # -- producing -----------------------------------------------------
    def emit(self, subsystem: str, kind: str, **data: Any) -> Event:
        return self.bus.emit(subsystem, kind, **data)

    def timed(self) -> _HostTally:
        return _HostTally(self)

    # -- derived views -------------------------------------------------
    def events(self, subsystem: Optional[str] = None,
               kind: Optional[str] = None) -> List[Event]:
        return self.bus.events(subsystem=subsystem, kind=kind)

    def timeline(self) -> Timeline:
        return Timeline.from_events(self.bus.events())

    def to_scenario(self, name: Optional[str] = None):
        return to_scenario(self.bus.events(), name=name)

    def snapshot(self) -> dict:
        """Metrics + timeline summary, JSON-ready."""
        return {"metrics": self.registry.snapshot(),
                "timeline": self.timeline().summary(),
                "events": {"retained": len(self.bus),
                           "emitted": self.bus.total_emitted,
                           "dropped": self.bus.dropped}}

    # -- persistence ---------------------------------------------------
    def dump(self, out_dir: str) -> dict:
        """Write the full telemetry bundle under ``out_dir``; returns the
        path map.  If no JSONL sink was attached, the retained ring is
        written out instead (bounded history)."""
        os.makedirs(out_dir, exist_ok=True)
        paths = {}
        evs = self.bus.events()
        if self.bus._jsonl_path is None:
            jsonl = os.path.join(out_dir, "events.jsonl")
            self.bus.attach_jsonl(jsonl)
            # back-fill the retained ring into the fresh sink
            with self.bus._lock:
                sink = self.bus._jsonl
            for ev in evs:
                sink.write(json.dumps(ev.to_dict()) + "\n")
            paths["events"] = jsonl
        else:
            paths["events"] = self.bus._jsonl_path
        self.bus.flush()
        paths["trace"] = write_chrome_trace(
            os.path.join(out_dir, "trace.json"), evs, self.timeline())
        paths["metrics_json"] = os.path.join(out_dir, "metrics.json")
        self.registry.to_json(paths["metrics_json"])
        paths["metrics_prom"] = os.path.join(out_dir, "metrics.prom")
        with open(paths["metrics_prom"], "w") as f:
            f.write(self.registry.to_prometheus())
        return paths

    def close(self) -> None:
        self.bus.close()
