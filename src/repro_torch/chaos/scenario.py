"""Declarative chaos scenarios: timed correlated-failure timelines (the
reference's ``chaos/scenario.py``).

A ``Scenario`` is a validated list of timed events — the trace a chaos run
replays.  Production failures arrive correlated (a rack loss during an SDC
storm under a flash crowd), so a scenario composes freely:

    sc = (Scenario("rack-loss-under-load", clock="step")
          .kill_hosts([2, 3], at=5)
          .sdc_storm(rate=0.2, window=(4, 12))
          .traffic_spike(mult=8, window=(3, 10))
          .rejoin(2, at=14))

or loads from a dict / JSON trace (``scenarios/*.json`` ships a canned
library)::

    sc = Scenario.from_json("scenarios/compound.json")

The event clock is **deterministic**: ``clock="step"`` keys events to
superstep / engine-step boundaries (training and serving — both loops are
step-driven), ``clock="time"`` keys them to virtual seconds (the
control-plane simulator).  Events are totally ordered
by ``(at, id)``, so two replays of one trace fire identically.

Event kinds (see docs/chaos.md for the full schema):

==============  =========================================================
kill_hosts      fail-stop of one or more hosts/replicas at ``at``
partition       drop heartbeat datagrams between ``groups`` in
                ``[at, heal_at)`` — the monitor sees asymmetric liveness
sdc_storm       bit-flips at ``rate`` per step over ``window`` (seeded,
                deterministic), optionally confined to ``leaves``
straggle        ``host`` runs ``factor``x slower over ``window``
traffic_spike   arrival rate multiplied by ``mult`` over ``window``
rejoin          a previously killed host comes back at ``at``
preempt         the scheduler's termination warning (SIGUSR1) at ``at``
precursor_storm ``host`` straggles at ``factor``x over ``window`` and
                then (``kill=True``, the default) fail-stops AT the
                window's end — the straggle-then-kill trace the
                telemetry plane's detectors must catch in time
==============  =========================================================

Drivers apply the kinds that exist on their plane and ignore the rest
(``traffic_spike`` means nothing to a training loop; ``preempt`` nothing
to the serving engine) — one JSON trace drives ``run_elastic`` (through
``chaos.driver.run_scenario_elastic``), the ``ServeEngine``, and the
simulator (``chaos.sim``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

KINDS = ("kill_hosts", "partition", "sdc_storm", "straggle",
         "traffic_spike", "rejoin", "preempt", "precursor_storm")
CLOCKS = ("step", "time")

#: kinds that occupy a ``[at, until)`` window rather than a point in time
WINDOW_KINDS = ("partition", "sdc_storm", "straggle", "traffic_spike",
                "precursor_storm")


class ScenarioError(ValueError):
    """A scenario failed validation (bad event args or timeline)."""


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One timed event.  ``until`` is None for point events; window events
    are active over ``[at, until)``."""
    eid: int
    kind: str
    at: float
    until: Optional[float]
    args: Dict[str, Any]

    def active(self, t: float) -> bool:
        if self.until is None:
            return t == self.at
        return self.at <= t < self.until

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"kind": self.kind, **self.args}
        if self.until is None:
            d["at"] = self.at
        else:
            d["window"] = [self.at, self.until]
        return d


def _check_window(kind: str, window) -> Tuple[float, float]:
    try:
        start, end = float(window[0]), float(window[1])
    except (TypeError, ValueError, IndexError):
        raise ScenarioError(f"{kind}: window must be (start, end), "
                            f"got {window!r}")
    if start < 0 or end <= start:
        raise ScenarioError(f"{kind}: need 0 <= start < end, "
                            f"got window={window!r}")
    return start, end


def _check_at(kind: str, at) -> float:
    try:
        at = float(at)
    except (TypeError, ValueError):
        raise ScenarioError(f"{kind}: 'at' must be a number, got {at!r}")
    if at < 0:
        raise ScenarioError(f"{kind}: 'at' must be >= 0, got {at}")
    return at


class Scenario:
    def __init__(self, name: str = "scenario", clock: str = "step",
                 seed: int = 0):
        if clock not in CLOCKS:
            raise ScenarioError(f"clock {clock!r} not in {CLOCKS}")
        self.name = name
        self.clock = clock
        self.seed = int(seed)
        self.events: List[ChaosEvent] = []

    # ------------------------------------------------------------------
    # builders (each validates, appends, and returns self for chaining)
    # ------------------------------------------------------------------
    def _add(self, kind: str, at: float, until: Optional[float],
             **args) -> "Scenario":
        self.events.append(ChaosEvent(len(self.events), kind, at, until,
                                      args))
        return self

    def kill_hosts(self, ids: Sequence[int], at: float) -> "Scenario":
        """Fail-stop hosts (training) / replicas (serving) ``ids`` at
        ``at``.  Several ids at one instant model a correlated rack loss."""
        ids = [int(i) for i in (ids if isinstance(ids, (list, tuple))
                                else [ids])]
        if not ids or len(set(ids)) != len(ids):
            raise ScenarioError(f"kill_hosts: ids must be non-empty and "
                                f"unique, got {ids!r}")
        return self._add("kill_hosts", _check_at("kill_hosts", at), None,
                         hosts=sorted(ids))

    def partition(self, groups: Sequence[Sequence[int]], at: float,
                  heal_at: float) -> "Scenario":
        """Drop heartbeat traffic between ``groups`` over [at, heal_at).
        Groups must be disjoint and non-empty; hosts not named keep full
        connectivity."""
        at = _check_at("partition", at)
        heal = _check_at("partition", heal_at)
        if heal <= at:
            raise ScenarioError(f"partition: heal_at ({heal_at}) must be "
                                f"> at ({at})")
        gs = [sorted(int(h) for h in g) for g in groups]
        if len(gs) < 2 or any(not g for g in gs):
            raise ScenarioError(f"partition: need >= 2 non-empty groups, "
                                f"got {groups!r}")
        seen: set = set()
        for g in gs:
            if seen.intersection(g):
                raise ScenarioError(f"partition: groups overlap on "
                                    f"{sorted(seen.intersection(g))}")
            seen.update(g)
        return self._add("partition", at, heal, groups=gs)

    def sdc_storm(self, rate: float, window: Sequence[float],
                  leaves: Optional[Sequence[str]] = None,
                  max_bit: int = 30) -> "Scenario":
        """Silent bit-flips at probability ``rate`` per step over
        ``window``, confined to state ``leaves`` (None: the driver picks
        from the registered state).  Seeded by ``Scenario.seed`` — two
        replays flip the same bits at the same steps."""
        if not 0 < float(rate) <= 1:
            raise ScenarioError(f"sdc_storm: rate must be in (0, 1], "
                                f"got {rate!r}")
        start, end = _check_window("sdc_storm", window)
        if max_bit < 1:
            raise ScenarioError(f"sdc_storm: max_bit must be >= 1, "
                                f"got {max_bit}")
        return self._add("sdc_storm", start, end, rate=float(rate),
                         leaves=(list(leaves) if leaves else None),
                         max_bit=int(max_bit))

    def straggle(self, host: int, factor: float,
                 window: Sequence[float]) -> "Scenario":
        """``host`` runs ``factor``x slower over ``window`` (fail-stutter:
        alive, beating, but late at every barrier)."""
        if float(factor) <= 1:
            raise ScenarioError(f"straggle: factor must be > 1, "
                                f"got {factor!r}")
        start, end = _check_window("straggle", window)
        return self._add("straggle", start, end, host=int(host),
                         factor=float(factor))

    def traffic_spike(self, mult: float,
                      window: Sequence[float]) -> "Scenario":
        """Arrival rate multiplied by ``mult`` over ``window`` (flash
        crowd).  Serving / simulator planes only."""
        if float(mult) < 1:
            raise ScenarioError(f"traffic_spike: mult must be >= 1, "
                                f"got {mult!r}")
        start, end = _check_window("traffic_spike", window)
        return self._add("traffic_spike", start, end, mult=float(mult))

    def rejoin(self, host: int, at: float) -> "Scenario":
        """A previously killed host comes back (grow event) at ``at``."""
        return self._add("rejoin", _check_at("rejoin", at), None,
                         host=int(host))

    def precursor_storm(self, host: int, factor: float,
                        window: Sequence[float],
                        kill: bool = True) -> "Scenario":
        """``host`` degrades visibly — ``factor``x slower over
        ``window`` — and then fail-stops at the window's END (unless
        ``kill=False``: a near-miss that recovers).  The canonical
        precursor trace for the telemetry plane (docs/observability.md):
        the straggle is the symptom the drift detector must turn into a
        ``precursor/*`` event early enough for a proactive checkpoint /
        pre-drain to land before the kill."""
        if float(factor) <= 1:
            raise ScenarioError(f"precursor_storm: factor must be > 1, "
                                f"got {factor!r}")
        start, end = _check_window("precursor_storm", window)
        return self._add("precursor_storm", start, end, host=int(host),
                         factor=float(factor), kill=bool(kill))

    def preempt(self, at: float, sig: str = "SIGUSR1") -> "Scenario":
        """Deliver the scheduler's preemption warning signal at ``at``
        (training plane: latch -> final checkpoint -> clean exit)."""
        if not sig.startswith("SIG"):
            raise ScenarioError(f"preempt: sig must be a signal name "
                                f"(SIGUSR1, ...), got {sig!r}")
        return self._add("preempt", _check_at("preempt", at), None, sig=sig)

    # ------------------------------------------------------------------
    # validation + queries
    # ------------------------------------------------------------------
    def validate(self) -> "Scenario":
        """Whole-timeline checks (builders validate per-event args):
        every rejoin names a host killed strictly earlier; a host is not
        killed twice without a rejoin in between.  Kill/rejoin actions
        are ordered by their EFFECTIVE time — ``kill_hosts`` and
        ``rejoin`` fire at ``at``, a killing ``precursor_storm`` at its
        window's ``until`` — so a storm's deferred kill pairs correctly
        with a later rejoin.  Returns self."""
        actions: List[Tuple[float, int, str, int]] = []
        for ev in self.sorted_events():
            if ev.kind == "kill_hosts":
                for h in ev.args["hosts"]:
                    actions.append((ev.at, ev.eid, "kill", h))
            elif ev.kind == "precursor_storm" and ev.args["kill"]:
                actions.append((ev.until, ev.eid, "kill",
                                ev.args["host"]))
            elif ev.kind == "rejoin":
                actions.append((ev.at, ev.eid, "rejoin",
                                ev.args["host"]))
        dead_since: Dict[int, float] = {}
        for t, _, action, h in sorted(actions):
            if action == "kill":
                if h in dead_since:
                    raise ScenarioError(
                        f"host {h} killed at t={t} but already dead "
                        f"since t={dead_since[h]} (no rejoin in "
                        "between)")
                dead_since[h] = t
            else:
                if h not in dead_since:
                    raise ScenarioError(
                        f"rejoin of host {h} at t={t} but it was never "
                        "killed before that")
                del dead_since[h]
        return self

    def sorted_events(self) -> List[ChaosEvent]:
        """Deterministic replay order: (at, insertion id)."""
        return sorted(self.events, key=lambda e: (e.at, e.eid))

    def point_events(self, kind: Optional[str] = None) -> List[ChaosEvent]:
        return [e for e in self.sorted_events() if e.until is None
                and (kind is None or e.kind == kind)]

    def window_events(self, kind: Optional[str] = None) -> List[ChaosEvent]:
        return [e for e in self.sorted_events() if e.until is not None
                and (kind is None or e.kind == kind)]

    def at(self, t: float, kind: Optional[str] = None) -> List[ChaosEvent]:
        """Point events firing exactly at ``t``."""
        return [e for e in self.point_events(kind) if e.at == t]

    def active(self, t: float,
               kind: Optional[str] = None) -> List[ChaosEvent]:
        """Window events whose [at, until) covers ``t``."""
        return [e for e in self.window_events(kind) if e.active(t)]

    @property
    def horizon(self) -> float:
        """Last instant anything happens (0 for an empty scenario)."""
        return max((e.at if e.until is None else e.until
                    for e in self.events), default=0.0)

    # ------------------------------------------------------------------
    # (de)serialization
    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "clock": self.clock, "seed": self.seed,
                "events": [e.to_dict() for e in self.sorted_events()]}

    def to_json(self, path: Optional[str] = None) -> str:
        text = json.dumps(self.to_dict(), indent=2)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Scenario":
        sc = cls(name=d.get("name", "scenario"),
                 clock=d.get("clock", "step"), seed=d.get("seed", 0))
        for i, ev in enumerate(d.get("events", ())):
            ev = dict(ev)
            kind = ev.pop("kind", None)
            if kind not in KINDS:
                raise ScenarioError(f"event {i}: kind {kind!r} not in "
                                    f"{KINDS}")
            try:
                if kind == "kill_hosts":
                    sc.kill_hosts(ev.pop("hosts"), at=ev.pop("at"))
                elif kind == "partition":
                    # accept either the serialized window form or the
                    # hand-written at/heal_at form
                    if "window" in ev:
                        start, heal = _check_window("partition",
                                                    ev.pop("window"))
                    else:
                        start, heal = ev.pop("at"), ev.pop("heal_at")
                    sc.partition(ev.pop("groups"), at=start, heal_at=heal)
                elif kind == "sdc_storm":
                    sc.sdc_storm(ev.pop("rate"), ev.pop("window"),
                                 leaves=ev.pop("leaves", None),
                                 max_bit=ev.pop("max_bit", 30))
                elif kind == "straggle":
                    sc.straggle(ev.pop("host"), ev.pop("factor"),
                                ev.pop("window"))
                elif kind == "traffic_spike":
                    sc.traffic_spike(ev.pop("mult"), ev.pop("window"))
                elif kind == "rejoin":
                    sc.rejoin(ev.pop("host"), at=ev.pop("at"))
                elif kind == "preempt":
                    sc.preempt(ev.pop("at"), sig=ev.pop("sig", "SIGUSR1"))
                elif kind == "precursor_storm":
                    sc.precursor_storm(ev.pop("host"), ev.pop("factor"),
                                       ev.pop("window"),
                                       kill=ev.pop("kill", True))
            except KeyError as e:
                raise ScenarioError(f"event {i} ({kind}): missing "
                                    f"required field {e}")
            if ev:
                raise ScenarioError(f"event {i} ({kind}): unknown fields "
                                    f"{sorted(ev)}")
        return sc.validate()

    @classmethod
    def from_json(cls, path_or_text: str) -> "Scenario":
        """Load from a JSON file path or a JSON string."""
        if os.path.exists(path_or_text):
            with open(path_or_text) as f:
                text = f.read()
        else:
            text = path_or_text
        try:
            d = json.loads(text)
        except ValueError as e:
            raise ScenarioError(f"not valid scenario JSON: {e}")
        return cls.from_dict(d)

    def __repr__(self) -> str:
        return (f"Scenario({self.name!r}, clock={self.clock!r}, "
                f"{len(self.events)} events, horizon={self.horizon})")
