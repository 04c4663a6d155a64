"""Per-incident failure timelines assembled from the event bus
(docs/observability.md); the reference's ``obs/timeline.py``.

An *incident* opens at a detection event (heartbeat declared a host dead,
the serving router failed a replica, an SDC tier tripped), collects every
repair-phase event that follows (final-save flush, drain/requeue,
restore, mesh shrink/grow, standby activation), and closes at the resume
event — training re-entered on the new mesh, recovery resumed the loop,
or a drained request's retry produced its first client-visible token.
Detections arriving while an incident is open *merge into it*: a rack
loss during an SDC storm is one compound incident, not three.

From the closed incidents the timeline derives the classic dependability
numbers:

- **MTTR**: mean detect -> resume duration.
- **MTBF**: mean gap between successive incident *starts* (>= 2 needed).
- **availability**: 1 - (repair time / observed span).

These are the measured counterparts of the ``SystemModel`` estimates the
Young/Daly policy is configured with — ``CheckpointPolicy
.observe_recovery`` lets the measured values displace the configured
ones live.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.bus import Event

#: (subsystem, kind) pairs that OPEN (or merge into) an incident
DETECT_KINDS = {
    ("heartbeat", "failure"),
    ("serve", "replica_failed"),
    ("sdc", "corruption"),
}

#: pairs that CLOSE the open incident (service restored)
RESUME_KINDS = {
    ("elastic", "resume"),
    ("train", "resume"),
    ("serve", "retry_first_token"),
}

#: pairs recorded as repair phases while an incident is open
PHASE_KINDS = {
    ("checkpoint", "save"),
    ("checkpoint", "restore"),
    ("elastic", "shrink"),
    ("elastic", "grow"),
    ("serve", "standby_activated"),
    ("heartbeat", "rejoin"),
    ("train", "interrupted"),
}


@dataclasses.dataclass
class Incident:
    """One detect -> ... -> resume episode."""
    t_detect: float                    # t_mono of the first detection
    cause: str                         # "subsystem.kind" of that detection
    detections: List[Event] = dataclasses.field(default_factory=list)
    phases: List[Event] = dataclasses.field(default_factory=list)
    t_resume: Optional[float] = None   # t_mono of the closing event
    resume_kind: Optional[str] = None

    @property
    def closed(self) -> bool:
        return self.t_resume is not None

    @property
    def duration(self) -> Optional[float]:
        """Repair time in seconds (None while open)."""
        if self.t_resume is None:
            return None
        return self.t_resume - self.t_detect

    def phase_offsets_ms(self) -> List[Tuple[float, str]]:
        """[(ms after detection, "subsystem.kind"), ...] — the repair
        critical path, human- and trace-readable."""
        out = []
        for ev in self.detections[1:] + self.phases:
            out.append(((ev.t_mono - self.t_detect) * 1e3,
                        f"{ev.subsystem}.{ev.kind}"))
        if self.t_resume is not None:
            out.append(((self.t_resume - self.t_detect) * 1e3,
                        f"resume:{self.resume_kind}"))
        return sorted(out)

    def to_dict(self) -> Dict:
        return {"t_detect": self.t_detect, "cause": self.cause,
                "detections": len(self.detections),
                "phases": [k for _, k in self.phase_offsets_ms()],
                "duration_s": self.duration,
                "resume": self.resume_kind}


class Timeline:
    """Incident list + derived MTTR / MTBF / availability."""

    def __init__(self, incidents: List[Incident],
                 span_seconds: float = 0.0,
                 t_end: Optional[float] = None):
        self.incidents = incidents
        self.span_seconds = span_seconds
        self.t_end = t_end                 # t_mono of the last event seen

    @classmethod
    def from_events(cls, events: Sequence[Event]) -> "Timeline":
        events = sorted(events, key=lambda e: (e.t_mono, e.seq))
        incidents: List[Incident] = []
        open_inc: Optional[Incident] = None
        for ev in events:
            key = (ev.subsystem, ev.kind)
            if key in DETECT_KINDS:
                if open_inc is None:
                    open_inc = Incident(t_detect=ev.t_mono,
                                        cause=f"{ev.subsystem}.{ev.kind}")
                    incidents.append(open_inc)
                open_inc.detections.append(ev)
            elif open_inc is not None and key in RESUME_KINDS:
                open_inc.t_resume = ev.t_mono
                open_inc.resume_kind = f"{ev.subsystem}.{ev.kind}"
                open_inc = None
            elif open_inc is not None and key in PHASE_KINDS:
                open_inc.phases.append(ev)
        span = (events[-1].t_mono - events[0].t_mono) if events else 0.0
        t_end = events[-1].t_mono if events else None
        return cls(incidents, span_seconds=span, t_end=t_end)

    # ------------------------------------------------------------------
    # derived dependability numbers
    # ------------------------------------------------------------------
    @property
    def closed(self) -> List[Incident]:
        return [i for i in self.incidents if i.closed]

    def mttr(self) -> Optional[float]:
        """Mean time to repair (seconds) over closed incidents."""
        ds = [i.duration for i in self.closed]
        return sum(ds) / len(ds) if ds else None

    def mtbf(self) -> Optional[float]:
        """Mean gap (seconds) between successive incident starts."""
        starts = sorted(i.t_detect for i in self.incidents)
        if len(starts) < 2:
            return None
        gaps = [b - a for a, b in zip(starts, starts[1:])]
        return sum(gaps) / len(gaps)

    def downtime(self) -> float:
        """Total repair seconds (open incidents count as down from their
        detection to the end of the log)."""
        total = 0.0
        for i in self.incidents:
            if i.closed:
                total += i.duration
            elif self.t_end is not None:
                total += max(0.0, self.t_end - i.t_detect)
        return total

    def availability(self) -> float:
        """1 - downtime/span over the observed window (1.0 for an empty
        or incident-free log)."""
        if self.span_seconds <= 0:
            return 1.0
        return max(0.0, 1.0 - self.downtime() / self.span_seconds)

    def summary(self) -> Dict:
        return {
            "incidents": len(self.incidents),
            "closed": len(self.closed),
            "mttr_s": self.mttr(),
            "mtbf_s": self.mtbf(),
            "availability": self.availability(),
            "span_s": self.span_seconds,
            "causes": sorted({i.cause for i in self.incidents}),
        }
