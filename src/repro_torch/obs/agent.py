"""TelemetryAgent: the per-host half of the telemetry plane
(docs/observability.md, "Telemetry plane"); the reference's
``obs/agent.py``.

Each host runs one agent.  It subscribes to the host's local
:class:`~repro_torch.obs.bus.EventBus`, buffers event records, and ships them
— together with metric *deltas* from the host's
:class:`~repro_torch.obs.metrics.MetricsRegistry` — as UDP datagrams to the
:class:`~repro_torch.obs.collector.Collector`.

The wire discipline is the heartbeat emitter's, applied to bulk data:

* **(inc, seq) ordering** — ``inc`` is stamped once per agent lifetime
  (``time.time()``), ``seq`` increments per datagram.  The collector
  orders pairs *per host* and never compares clocks across hosts; a
  restarted agent (new ``inc``) supersedes its past self exactly like a
  restarted heartbeat emitter does.
* **loss-tolerant** — fire-and-forget UDP; a seq gap at the collector
  becomes per-host gap accounting (a ``telemetry/gap`` event), never a
  stall.  The agent keeps a bounded buffer and counts what it sheds.
* **no cross-host clock comparison** — each datagram carries the
  host-local ``t_send`` (``perf_counter``); the collector maps it into
  its own clock domain with a per-host offset (min one-way delay), so
  same-host time *differences* — the inputs to MTTR/MTBF math — survive
  the merge exactly.

``skew_seconds`` offsets every timestamp the agent puts on the wire
(event ``t_mono`` and ``t_send`` alike), simulating a host whose
monotonic clock domain disagrees with the collector's — the skew the
offset mapping must cancel.  Tests and the chaos engine use it; real
deployments leave it 0.

Metric shipping is delta-based for counters (the collector accumulates,
so a lost datagram loses a delta — bounded error, no double count) and
last-value for gauges.
"""
from __future__ import annotations

import json
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .bus import Event, EventBus
from .metrics import Counter, Gauge, MetricsRegistry, _label_str

__all__ = ["TelemetryAgent"]

#: events buffered while waiting for the next ship (bounded: the agent
#: sheds oldest-first under backpressure and counts what it dropped)
BUFFER_CAP = 4096

#: max event records per datagram — keeps each JSON payload well under
#: typical UDP limits
CHUNK = 100


class TelemetryAgent:
    """Ships one host's telemetry to the collector.

    ``send_filter(host_id, payload) -> bool`` gates every datagram the
    same way the heartbeat emitter's does — the chaos engine's
    partition hook drops telemetry and heartbeats with one knob."""

    def __init__(self, host_id: int, collector_addr: Tuple[str, int],
                 bus: EventBus,
                 registry: Optional[MetricsRegistry] = None,
                 period: float = 0.05, chunk: int = CHUNK,
                 buffer_cap: int = BUFFER_CAP,
                 skew_seconds: float = 0.0,
                 send_filter: Optional[Callable[[int, Dict], bool]]
                 = None):
        self.host_id = host_id
        self.collector_addr = collector_addr
        self.bus = bus
        self.registry = registry
        self.period = period
        self.chunk = chunk
        self.skew_seconds = skew_seconds
        self.send_filter = send_filter
        self._inc = time.time()          # lifetime tag (heartbeat idiom)
        self._seq = 0
        self._buf: deque = deque(maxlen=buffer_cap)
        self.shed = 0                    # events dropped to the buffer cap
        self.sent_datagrams = 0
        self._counters_last: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()   # serializes whole flushes
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sub: Optional[Callable] = None

    # -- event intake (bus subscriber, runs on emitting threads) -------
    def _on_event(self, ev: Event) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.shed += 1
            d = ev.to_dict()
            d["t_mono"] = ev.t_mono + self.skew_seconds
            self._buf.append(d)

    # -- shipping ------------------------------------------------------
    def _metric_payload(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        """(counter deltas since last ship, gauge last-values)."""
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        if self.registry is None:
            return counters, gauges
        for inst in self.registry.instruments():
            key = inst.name + _label_str(inst.labels)
            if isinstance(inst, Counter):
                v = inst.value
                delta = v - self._counters_last.get(key, 0.0)
                if delta:
                    counters[key] = delta
                self._counters_last[key] = v
            elif isinstance(inst, Gauge):
                gauges[key] = inst.value
        return counters, gauges

    def flush(self) -> int:
        """Ship everything buffered now (plus one metrics snapshot);
        returns the number of datagrams sent.  Called by the background
        thread each period and directly by tests/shutdown."""
        with self._flush_lock:
            return self._flush_locked()

    def _flush_locked(self) -> int:
        with self._lock:
            events: List[Dict[str, Any]] = list(self._buf)
            self._buf.clear()
            counters, gauges = self._metric_payload()
        sent = 0
        chunks: List[List[Dict[str, Any]]] = [
            events[i:i + self.chunk]
            for i in range(0, len(events), self.chunk)] or [[]]
        if not counters and not gauges and not events:
            return 0                     # nothing to say: stay silent
        for i, part in enumerate(chunks):
            payload = {"host": self.host_id, "inc": self._inc,
                       "seq": self._seq,
                       "t_send": time.perf_counter() + self.skew_seconds,
                       "events": part}
            if i == 0:                   # metrics ride the first chunk
                payload["counters"] = counters
                payload["gauges"] = gauges
            self._seq += 1
            if (self.send_filter is not None
                    and not self.send_filter(self.host_id, payload)):
                continue                 # chaos-dropped: seq gap downstream
            try:
                self._sock.sendto(json.dumps(payload).encode(),
                                  self.collector_addr)
                sent += 1
            except OSError:
                pass                     # fire-and-forget: loss-tolerant
        self.sent_datagrams += sent
        return sent

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            self.flush()

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "TelemetryAgent":
        self._sub = self.bus.subscribe(self._on_event)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"telemetry-agent-"
                                             f"{self.host_id}")
        self._thread.start()
        return self

    def stop(self, final_flush: bool = True) -> None:
        if self._sub is not None:
            self.bus.unsubscribe(self._sub)
            self._sub = None
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if final_flush:
            self.flush()
        self._sock.close()
