"""Online anomaly detection over the merged telemetry stream
(docs/observability.md, "Telemetry plane"); the reference's
``obs/anomaly.py``.

Detectors watch the event stream the :class:`~repro_torch.obs.collector.
Collector` merges (or a local :class:`~repro_torch.obs.bus.EventBus`, for the
single-process plane) and emit ``precursor/*`` events when a host
starts *looking* like it is about to fail — before the heartbeat
monitor or sentinel declares it dead.  FTHP-MPI's argument (PAPERS.md)
is that fault tolerance should act ahead of the failure's arrival on
the critical path; the precursors here are the triggers for that
proactive action: a risk-adjusted Young/Daly interval
(``CheckpointPolicy(mode="risk_adjusted")``), a forced checkpoint
(:func:`make_proactive_hook` -> ``run_bsp(proactive=...)``), and a
serve-replica pre-drain (``ServeEngine(risk_source=...)``).

Three detectors, one per failure precursor the chaos engine can stage:

* :class:`StepTimeDriftDetector` — EWMA baseline of per-host step
  seconds (``train/step`` and ``telemetry/replica_step`` events); a run
  of ``consecutive`` samples above ``factor`` x the baseline fires.
  Catches stragglers (thermal throttling, a dying NIC) ahead of the
  fail-stop they often precede.
* :class:`BeatJitterDetector` — EWMA baseline of datagram inter-arrival
  per host; sustained inter-arrival blowup fires before the heartbeat
  monitor's hard timeout does (the monitor needs ``timeout_factor``
  missed periods; jitter shows up earlier).
* :class:`ScrubRateDetector` — trailing-window count of SDC detections
  (``sdc/*`` events) per host; an accelerating hit rate means a memory/
  logic path is degrading, not a one-off flip.

:class:`AnomalyEngine` multiplexes events to the detectors and folds
their firings into one per-host risk score in [0, 1]: firings max-merge
in, healthy step samples decay it (``decay`` per sample).  The score is
what downstream consumers read — they never see individual detectors.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from .bus import Event, EventBus

__all__ = ["AnomalyEngine", "BeatJitterDetector", "ScrubRateDetector",
           "StepTimeDriftDetector", "make_proactive_hook"]


class StepTimeDriftDetector:
    """EWMA step-time drift: fires when ``consecutive`` successive step
    durations from one host exceed ``factor`` x that host's EWMA
    baseline.  The baseline only absorbs *healthy* samples — anomalous
    ones are excluded so a sustained straggle cannot normalize itself
    into the mean."""

    kind = "step_time_drift"

    #: event (subsystem, kind) pairs that carry a step duration
    WATCHED = (("train", "step"), ("telemetry", "replica_step"))

    def __init__(self, factor: float = 2.0, consecutive: int = 3,
                 alpha: float = 0.2, warmup: int = 3):
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1, got {factor}")
        self.factor = factor
        self.consecutive = consecutive
        self.alpha = alpha
        self.warmup = warmup
        self._mean: Dict[int, float] = {}
        self._n: Dict[int, int] = {}
        self._streak: Dict[int, int] = {}

    def observe(self, origin: int, ev: Event) -> Optional[float]:
        if (ev.subsystem, ev.kind) not in self.WATCHED:
            return None
        dt = ev.data.get("seconds")
        if dt is None:
            return None
        host = int(ev.data.get("host", origin))
        n = self._n.get(host, 0)
        mean = self._mean.get(host, float(dt))
        if n >= self.warmup and dt > self.factor * mean:
            streak = self._streak.get(host, 0) + 1
            self._streak[host] = streak
            if streak >= self.consecutive:
                self._streak[host] = 0     # refractory: re-arm from zero
                excess = dt / (self.factor * mean) - 1.0
                return min(1.0, 0.5 + 0.5 * excess)
            return None
        self._streak[host] = 0
        self._mean[host] = (1 - self.alpha) * mean + self.alpha * float(dt)
        self._n[host] = n + 1
        return None


class BeatJitterDetector:
    """Datagram inter-arrival jitter: fires when ``consecutive``
    successive inter-arrival gaps from one host exceed ``factor`` x
    that host's EWMA inter-arrival baseline.  Fed by the collector's
    receive loop (``observe_arrival``), not by events — loss and delay
    both stretch the gap, and both are precursors."""

    kind = "beat_jitter"

    def __init__(self, factor: float = 3.0, consecutive: int = 2,
                 alpha: float = 0.2, warmup: int = 3):
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1, got {factor}")
        self.factor = factor
        self.consecutive = consecutive
        self.alpha = alpha
        self.warmup = warmup
        self._last: Dict[int, float] = {}
        self._mean: Dict[int, float] = {}
        self._n: Dict[int, int] = {}
        self._streak: Dict[int, int] = {}

    def observe_arrival(self, host: int, t: float) -> Optional[float]:
        last = self._last.get(host)
        self._last[host] = t
        if last is None:
            return None
        gap = t - last
        n = self._n.get(host, 0)
        mean = self._mean.get(host, gap)
        if n >= self.warmup and gap > self.factor * mean:
            streak = self._streak.get(host, 0) + 1
            self._streak[host] = streak
            if streak >= self.consecutive:
                self._streak[host] = 0
                excess = gap / (self.factor * mean) - 1.0
                return min(1.0, 0.5 + 0.5 * excess)
            return None
        self._streak[host] = 0
        self._mean[host] = (1 - self.alpha) * mean + self.alpha * gap
        self._n[host] = n + 1
        return None

    def observe(self, origin: int, ev: Event) -> Optional[float]:
        return None                      # arrival-driven, not event-driven


class ScrubRateDetector:
    """SDC hit-rate acceleration: keeps each host's last ``window``
    detection timestamps (any ``sdc/*`` event); fires once the window
    fills AND spans less than ``max_span`` seconds — i.e. detections
    are arriving fast, not trickling.  A single flip never fires."""

    kind = "scrub_rate"

    def __init__(self, window: int = 3, max_span: float = 60.0):
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        self.window = window
        self.max_span = max_span
        self._hits: Dict[int, List[float]] = {}

    def observe(self, origin: int, ev: Event) -> Optional[float]:
        if ev.subsystem != "sdc":
            return None
        host = int(ev.data.get("host", origin))
        hits = self._hits.setdefault(host, [])
        hits.append(ev.t_mono)
        if len(hits) > self.window:
            del hits[:-self.window]
        if len(hits) == self.window:
            span = hits[-1] - hits[0]
            if span < self.max_span:
                self._hits[host] = []    # refractory
                return min(1.0, 0.5 + 0.5 *
                           (1.0 - span / max(self.max_span, 1e-9)))
        return None


class AnomalyEngine:
    """Multiplexes a telemetry stream to the detectors and folds their
    firings into per-host risk scores in [0, 1].

    * a detector firing with score ``s`` max-merges: ``risk = max(risk,
      s)`` — a fresh, stronger signal always wins;
    * every *healthy* step-like sample from a host decays its risk by
      ``decay`` — risk is a leaky accumulator, quiet hosts drift back
      to 0.

    ``emit`` (if given) receives ``("precursor", <detector.kind>,
    host=..., score=..., risk=...)`` on each firing — wire it to an
    ``EventBus.emit`` (local plane) or the collector's merge hook
    (cross-host plane) so precursors land in the same stream they were
    detected from.  ``on_precursor(host, kind, risk)`` is the low-
    latency callback path for the proactive hooks."""

    def __init__(self, detectors: Optional[List[Any]] = None,
                 decay: float = 0.9,
                 on_precursor: Optional[Callable[[int, str, float],
                                                 None]] = None,
                 emit: Optional[Callable[..., Any]] = None):
        self.detectors = (list(detectors) if detectors is not None else
                          [StepTimeDriftDetector(), BeatJitterDetector(),
                           ScrubRateDetector()])
        self.decay = decay
        self.on_precursor = on_precursor
        self.emit = emit
        self._risk: Dict[int, float] = {}
        self._lock = threading.Lock()
        self.precursors = 0              # total firings, for quick asserts

    # -- stream input --------------------------------------------------
    def observe_event(self, origin: int, ev: Event) -> None:
        if ev.subsystem == "precursor":
            return                       # our own output: never re-ingest
        fired = []
        with self._lock:
            for det in self.detectors:
                score = det.observe(origin, ev)
                if score is not None:
                    fired.append((det.kind, score))
            host = int(ev.data.get("host", origin))
            if not fired and (ev.subsystem, ev.kind) in \
                    StepTimeDriftDetector.WATCHED:
                if host in self._risk:
                    self._risk[host] *= self.decay
            for _, score in fired:
                self._risk[host] = max(self._risk.get(host, 0.0), score)
            risk = self._risk.get(host, 0.0)
        for det_kind, score in fired:
            self._fire(host, det_kind, score, risk)

    def observe_arrival(self, host: int, t: float) -> None:
        """Feed a datagram arrival (collector receive loop)."""
        fired = None
        with self._lock:
            for det in self.detectors:
                fn = getattr(det, "observe_arrival", None)
                if fn is None:
                    continue
                score = fn(host, t)
                if score is not None:
                    self._risk[host] = max(self._risk.get(host, 0.0),
                                           score)
                    fired = (det.kind, score)
            risk = self._risk.get(host, 0.0)
        if fired is not None:
            self._fire(host, fired[0], fired[1], risk)

    def _fire(self, host: int, det_kind: str, score: float,
              risk: float) -> None:
        self.precursors += 1
        if self.emit is not None:
            self.emit("precursor", det_kind, host=host, score=score,
                      risk=risk)
        if self.on_precursor is not None:
            self.on_precursor(host, det_kind, risk)

    # -- risk output ---------------------------------------------------
    def risk(self, host: int) -> float:
        with self._lock:
            return self._risk.get(host, 0.0)

    def risk_scores(self) -> Dict[int, float]:
        with self._lock:
            return dict(self._risk)

    # -- local (single-process) plane ----------------------------------
    def attach(self, bus: EventBus, origin: int = 0) -> Callable:
        """Subscribe to a local bus: events flow straight into the
        detectors and precursors are emitted back onto the same bus —
        the in-process degenerate case of the agent->collector plane."""
        if self.emit is None:
            self.emit = bus.emit

        def _on_event(ev: Event) -> None:
            self.observe_event(origin, ev)

        return bus.subscribe(_on_event)


def make_proactive_hook(source: Callable[[], Dict[int, float]],
                        threshold: float = 0.5,
                        cooldown_steps: int = 10,
                        policy: Optional[Any] = None
                        ) -> Callable[[int], Optional[str]]:
    """Build the ``proactive=`` hook ``run_bsp`` calls
    once per superstep: reads ``source()`` (host -> risk, e.g.
    ``engine.risk_scores`` or ``collector.risk_scores``), feeds the max
    into ``policy.observe_risk`` (if a risk-adjusted policy is given),
    and returns a reason string — forcing a checkpoint — when any
    host's risk crosses ``threshold``.  ``cooldown_steps`` rate-limits
    forced saves so a persistently risky host doesn't checkpoint every
    step."""
    last_fired = [-10**9]

    def hook(step: int) -> Optional[str]:
        scores = source()
        if policy is not None:
            policy.observe_risk(max(scores.values(), default=0.0))
        if step - last_fired[0] < cooldown_steps:
            return None
        hot = [(r, h) for h, r in scores.items() if r >= threshold]
        if not hot:
            return None
        r, h = max(hot)
        last_fired[0] = step
        return f"risk:{h}:{r:.2f}"

    return hook
