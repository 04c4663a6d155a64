"""Collector: the global half of the telemetry plane
(docs/observability.md, "Telemetry plane"); the reference's
``obs/collector.py``.

One collector per deployment receives the
:class:`~repro_torch.obs.agent.TelemetryAgent` datagrams from every host and
merges them into a single, globally ordered event stream a
:class:`~repro_torch.obs.timeline.Timeline` can fold — without ever comparing
one host's clock to another's:

* **(inc, seq) acceptance** — per host, a datagram is accepted iff its
  ``(inc, seq)`` exceeds the last accepted pair (heartbeat idiom: a
  restarted agent's fresh ``inc`` supersedes; duplicates and stale
  reordered datagrams are counted as ``stale`` and dropped).
* **skew-tolerant merge** — per host the collector maintains
  ``offset = min over datagrams of (t_recv - t_send)``: the minimum
  observed one-way delay, in collector-clock terms, including any agent
  clock skew.  Merged events get ``t_mono = host t_mono + offset``.
  Same-host differences are preserved *exactly* (one constant per
  host), so MTTR/MTBF math over the merged stream matches the
  single-host oracle; cross-host ordering is correct to within the
  (small, bounded) one-way-delay estimation error.
* **gap accounting** — a seq jump means lost datagrams; the collector
  counts the missing span per host and synthesizes a ``telemetry/gap``
  event into the merged stream, so downstream consumers *see* the hole
  instead of silently reading a thinner stream.

Every merged event is tagged ``origin=<host>`` (unless the payload
already names a host).  The optional
:class:`~repro_torch.obs.anomaly.AnomalyEngine` rides the receive path:
datagram arrivals feed the jitter detector, merged events feed the
drift/scrub detectors, and emitted ``precursor/*`` events land in the
same merged stream — making the collector the risk source for
proactive checkpointing and serve pre-drains.
"""
from __future__ import annotations

import json
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .bus import Event
from .timeline import Timeline

__all__ = ["Collector"]

#: merged-stream bound — same discipline as the EventBus ring
DEFAULT_CAPACITY = 50_000


class _HostState:
    __slots__ = ("inc", "last_seq", "offset", "datagrams", "missed",
                 "stale")

    def __init__(self) -> None:
        self.inc = 0.0
        self.last_seq = -1
        self.offset: Optional[float] = None
        self.datagrams = 0
        self.missed = 0                  # datagrams lost to seq gaps
        self.stale = 0                   # duplicates / reordered stragglers


class Collector:
    def __init__(self, bind: Tuple[str, int] = ("127.0.0.1", 0),
                 anomaly: Optional[Any] = None,
                 capacity: int = DEFAULT_CAPACITY):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(bind)
        self._sock.settimeout(0.1)
        self.addr = self._sock.getsockname()
        self.anomaly = anomaly
        if anomaly is not None and anomaly.emit is None:
            anomaly.emit = self._emit_merged
        self.capacity = capacity
        #: (host clock-domain or None for collector-clock, local t_mono,
        #: event) — the offset is applied at *snapshot* time, so every
        #: event from a host always maps through that host's latest
        #: (best) offset estimate and same-host differences stay exact
        self._events: List[Tuple[Optional[int], float, Event]] = []
        self._seq = 0                    # collector-local merge order tag
        self._hosts: Dict[int, _HostState] = {}
        self._counters: Dict[int, Dict[str, float]] = {}
        self._gauges: Dict[int, Dict[str, float]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- ingest (the whole merge protocol; directly callable) ----------
    def ingest(self, payload: Dict[str, Any],
               t_recv: Optional[float] = None) -> bool:
        """Merge one agent datagram; returns False if it was stale.
        ``t_recv`` defaults to now (collector clock) — tests and the
        throughput bench pass explicit values."""
        if t_recv is None:
            t_recv = time.perf_counter()
        host = int(payload["host"])
        inc = float(payload["inc"])
        seq = int(payload["seq"])
        merged: List[Event] = []
        with self._lock:
            st = self._hosts.setdefault(host, _HostState())
            if inc > st.inc:             # restarted agent supersedes
                st.inc, st.last_seq, st.offset = inc, -1, None
            elif inc < st.inc or seq <= st.last_seq:
                st.stale += 1
                return False
            if seq > st.last_seq + 1:    # lost datagrams: account + mark
                n = seq - st.last_seq - 1
                st.missed += n
                merged.append(self._make_event(
                    t_recv, "telemetry", "gap",
                    {"origin": host, "missed_datagrams": n,
                     "after_seq": st.last_seq}))
            st.last_seq = seq
            st.datagrams += 1
            # min one-way delay = the host->collector clock mapping
            delay = t_recv - float(payload["t_send"])
            st.offset = delay if st.offset is None else min(st.offset,
                                                            delay)
            for d in payload.get("events", ()):
                ev = Event.from_dict(d)
                data = dict(ev.data)
                data.setdefault("origin", host)
                merged.append(self._stamp(Event(
                    seq=0, t_mono=ev.t_mono, t_wall=ev.t_wall,
                    subsystem=ev.subsystem, kind=ev.kind, data=data),
                    domain=host))
            for k, v in payload.get("counters", {}).items():
                c = self._counters.setdefault(host, {})
                c[k] = c.get(k, 0.0) + float(v)
            if payload.get("gauges"):
                self._gauges.setdefault(host, {}).update(
                    payload["gauges"])
        # detectors run OUTSIDE the lock: they may emit back into us
        if self.anomaly is not None:
            self.anomaly.observe_arrival(host, t_recv)
            for ev in merged:
                self.anomaly.observe_event(host, ev)
        return True

    def _make_event(self, t_mono: float, subsystem: str, kind: str,
                    data: Dict[str, Any]) -> Event:
        return self._stamp(Event(seq=0, t_mono=t_mono,
                                 t_wall=time.time(),
                                 subsystem=subsystem, kind=kind,
                                 data=data))

    def _stamp(self, ev: Event, domain: Optional[int] = None) -> Event:
        """Append under the lock (caller holds it), tagging a collector-
        local seq so equal-t_mono events keep arrival order.  ``domain``
        names the host clock domain ``t_mono`` lives in (None =
        collector clock)."""
        ev = Event(seq=self._seq, t_mono=ev.t_mono, t_wall=ev.t_wall,
                   subsystem=ev.subsystem, kind=ev.kind, data=ev.data)
        self._seq += 1
        self._events.append((domain, ev.t_mono, ev))
        if len(self._events) > self.capacity:
            del self._events[:len(self._events) - self.capacity]
        return ev

    def _emit_merged(self, subsystem: str, kind: str,
                     **data: Any) -> Event:
        """AnomalyEngine's emit target: precursors join the merged
        stream, stamped with the collector's own clock."""
        with self._lock:
            return self._make_event(time.perf_counter(), subsystem,
                                    kind, data)

    # -- merged-stream output ------------------------------------------
    def events(self, subsystem: Optional[str] = None,
               kind: Optional[str] = None) -> List[Event]:
        """Snapshot of the merged stream in global (t_mono, seq) order,
        every host-domain timestamp mapped through that host's current
        offset estimate."""
        with self._lock:
            offs = {h: (st.offset or 0.0)
                    for h, st in self._hosts.items()}
            evs = [Event(seq=ev.seq,
                         t_mono=t + (offs.get(dom, 0.0)
                                     if dom is not None else 0.0),
                         t_wall=ev.t_wall, subsystem=ev.subsystem,
                         kind=ev.kind, data=ev.data)
                   for dom, t, ev in self._events]
        evs.sort(key=lambda e: (e.t_mono, e.seq))
        return [e for e in evs
                if (subsystem is None or e.subsystem == subsystem)
                and (kind is None or e.kind == kind)]

    def timeline(self) -> Timeline:
        return Timeline.from_events(self.events())

    def gap_report(self) -> Dict[int, Dict[str, int]]:
        """Per-host wire accounting: datagrams merged, datagrams lost
        (seq gaps), stale drops."""
        with self._lock:
            return {h: {"datagrams": st.datagrams, "missed": st.missed,
                        "stale": st.stale}
                    for h, st in sorted(self._hosts.items())}

    def host_metrics(self) -> Dict[int, Dict[str, Dict[str, float]]]:
        """Per-host merged metrics: accumulated counter deltas and
        last-seen gauges."""
        with self._lock:
            return {h: {"counters": dict(self._counters.get(h, {})),
                        "gauges": dict(self._gauges.get(h, {}))}
                    for h in sorted(set(self._counters)
                                    | set(self._gauges))}

    # -- risk passthrough (the proactive hooks' source) ----------------
    def risk_scores(self) -> Dict[int, float]:
        return (self.anomaly.risk_scores() if self.anomaly is not None
                else {})

    def risk(self, host: int) -> float:
        return (self.anomaly.risk(host) if self.anomaly is not None
                else 0.0)

    # -- lifecycle -----------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                data, _ = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                payload = json.loads(data.decode())
            except (ValueError, UnicodeDecodeError):
                continue                 # garbage datagram: drop
            try:
                self.ingest(payload)
            except (KeyError, TypeError, ValueError):
                continue                 # malformed payload: drop

    def start(self) -> "Collector":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="telemetry-collector")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self._sock.close()
