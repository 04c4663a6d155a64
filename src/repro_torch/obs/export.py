"""Exporters for recorded event logs (docs/observability.md); the
reference's ``obs/export.py``.

Two consumers of a recorded bus:

- ``to_chrome_trace`` / ``write_chrome_trace`` — Chrome ``about:tracing``
  / Perfetto JSON.  Each subsystem becomes a named track of instant
  events; closed incidents from the ``Timeline`` become duration bars on
  an "incidents" track, so a compound failure reads as one shaded span
  with the detect/drain/restore/resume marks inside it.

- ``to_scenario`` — convert a recorded event log back into a replayable
  chaos ``Scenario``, closing the record-and-replay loop the ROADMAP
  asks for.  Two paths:

  1. **Declarative** (exact): the chaos drivers emit one
     ``chaos/<kind>`` event per compiled scenario event, carrying the
     original ``at``/``until``/args, plus a ``chaos/scenario`` meta
     event with name/clock/seed.  Reconstruction is lossless — the
     round-trip scenario replays bit-identically (same seed, same
     storm draws).

  2. **Derived** (production logs): with no declarative events the
     converter falls back to the raw detection stream — heartbeat
     failures/rejoins and serve replica failures become
     kill/rejoin events, injected bit-flips become an ``sdc_storm``
     window — on a ``clock="time"`` axis relative to the first event.
     That is the "replay recorded production failure logs" path.

The result replays through the chaos drivers
(``chaos.driver``) and the control-plane simulator (``chaos.sim``).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.chaos.scenario import KINDS, WINDOW_KINDS, Scenario
from repro_torch.obs.bus import Event
from repro_torch.obs.timeline import Timeline

# ----------------------------------------------------------------------
# Chrome trace (catapult JSON) export
# ----------------------------------------------------------------------
_PID = 1
_INCIDENT_TID = 0


def to_chrome_trace(events: Sequence[Event],
                    timeline: Optional[Timeline] = None) -> Dict[str, Any]:
    """Build a ``chrome://tracing`` / Perfetto-loadable trace dict.

    Timestamps are microseconds relative to the first event; one thread
    track per subsystem; incidents (if a timeline is given, else built
    here) render as duration ("X") bars on track 0.
    """
    events = sorted(events, key=lambda e: (e.t_mono, e.seq))
    if timeline is None:
        timeline = Timeline.from_events(events)
    t0 = events[0].t_mono if events else 0.0
    tids: Dict[str, int] = {}
    trace: List[Dict[str, Any]] = [
        {"name": "thread_name", "ph": "M", "pid": _PID,
         "tid": _INCIDENT_TID, "args": {"name": "incidents"}},
    ]
    for ev in events:
        tid = tids.setdefault(ev.subsystem, len(tids) + 1)
        trace.append({
            "name": f"{ev.subsystem}.{ev.kind}",
            "ph": "i", "s": "t",                 # thread-scoped instant
            "ts": (ev.t_mono - t0) * 1e6,
            "pid": _PID, "tid": tid,
            "args": dict(ev.data),
        })
    for sub, tid in tids.items():
        trace.append({"name": "thread_name", "ph": "M", "pid": _PID,
                      "tid": tid, "args": {"name": sub}})
    for inc in timeline.incidents:
        end = inc.t_resume if inc.closed else timeline.t_end
        if end is None:
            continue
        trace.append({
            "name": f"incident:{inc.cause}",
            "ph": "X",
            "ts": (inc.t_detect - t0) * 1e6,
            "dur": max(0.0, (end - inc.t_detect)) * 1e6,
            "pid": _PID, "tid": _INCIDENT_TID,
            "args": {"closed": inc.closed, "resume": inc.resume_kind,
                     "detections": len(inc.detections)},
        })
    return {"traceEvents": trace, "displayTimeUnit": "ms",
            "otherData": {"summary": timeline.summary()}}


def write_chrome_trace(path: str, events: Sequence[Event],
                       timeline: Optional[Timeline] = None) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(events, timeline), f, indent=2)
        f.write("\n")
    return path


# ----------------------------------------------------------------------
# event log -> Scenario (replay side of record-and-replay)
# ----------------------------------------------------------------------
def to_scenario(events: Sequence[Event],
                name: Optional[str] = None) -> Scenario:
    """Convert a recorded event stream back into a chaos ``Scenario``.

    Prefers the declarative ``chaos/*`` events the drivers emit at
    scenario compile time (lossless round trip, including the storm
    seed); falls back to deriving a fail-stop/SDC timeline from the raw
    detection events when the log came from an uninstrumented-by-chaos
    run (a "production" log).  The result is validated.
    """
    events = sorted(events, key=lambda e: (e.t_mono, e.seq))
    chaos_evs = [e for e in events if e.subsystem == "chaos"]
    declarative = [e for e in chaos_evs if e.kind in KINDS]
    if declarative:
        return _from_declarative(chaos_evs, declarative, name)
    return _from_detections(events, name)


def _from_declarative(chaos_evs: Sequence[Event],
                      declarative: Sequence[Event],
                      name: Optional[str]) -> Scenario:
    meta: Dict[str, Any] = {}
    for e in chaos_evs:
        if e.kind == "scenario":
            meta = dict(e.data)
            break
    ev_dicts: List[Dict[str, Any]] = []
    for e in declarative:
        d = dict(e.data)
        d.pop("plane", None)                 # driver tag, not a field
        at = d.pop("at")
        until = d.pop("until", None)
        d["kind"] = e.kind
        if e.kind in WINDOW_KINDS and until is not None:
            d["window"] = [at, until]
        else:
            d["at"] = at
        ev_dicts.append(d)
    return Scenario.from_dict({
        "name": name or meta.get("name", "replay"),
        "clock": meta.get("clock", "step"),
        "seed": meta.get("seed", 0),
        "events": ev_dicts,
    })


def _host_of(ev: Event) -> Optional[int]:
    for key in ("host", "replica", "rid"):
        if key in ev.data:
            try:
                return int(ev.data[key])
            except (TypeError, ValueError):
                return None
    return None


def _from_detections(events: Sequence[Event],
                     name: Optional[str]) -> Scenario:
    """Derive a time-clock scenario from raw detection events."""
    t0 = events[0].t_mono if events else 0.0
    sc = Scenario(name or "derived-replay", clock="time")
    dead: set = set()
    flips: List[Event] = []
    for ev in events:
        rel = round(ev.t_mono - t0, 6)
        key = (ev.subsystem, ev.kind)
        host = _host_of(ev)
        if key in (("heartbeat", "failure"), ("serve", "replica_failed")):
            if host is not None and host not in dead:
                sc.kill_hosts([host], at=rel)
                dead.add(host)
        elif key == ("heartbeat", "rejoin"):
            if host is not None and host in dead:
                sc.rejoin(host, at=rel)
                dead.discard(host)
        elif ev.subsystem == "injector" and ev.kind == "bitflip":
            flips.append(ev)
    if flips:
        start = round(flips[0].t_mono - t0, 6)
        end = round(flips[-1].t_mono - t0, 6)
        width = max(end - start, 1e-3)
        if end <= start:
            end = start + width
        rate = min(1.0, max(1e-6, len(flips) / width))
        leaves = sorted({e.data["leaf"] for e in flips if "leaf" in e.data})
        sc.sdc_storm(rate=rate, window=(start, end),
                     leaves=leaves or None)
    return sc.validate()
