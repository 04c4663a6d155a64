"""Scenario drivers (the reference's ``chaos/driver.py``): compile a
``Scenario`` onto the live fault-injection hooks and drive the training
and serving loops through it.

Two adapters share one trace format (``repro_torch.chaos.scenario``):

- ``TrainScenarioDriver`` + ``run_scenario_elastic`` replay a scenario
  against ``core.elastic_loop.run_elastic`` on a rank mesh: kills pause
  heartbeat emitters (the monitor detects, the mesh shrinks), rejoins
  resume them (grow), partitions drop emitter datagrams via the heartbeat
  layer's ``send_filter`` network gate (asymmetric liveness — the
  partitioned host keeps running and believes it is connected), SDC
  storms compile to seeded ``schedule_bitflip`` schedules, straggles to
  ``schedule_straggle``, and ``preempt`` to the termination signal.
  ``run_scenario_elastic`` additionally closes the corruption loop the
  elastic runner alone leaves open: a storm flip detected by the scrubber
  raises ``CorruptionDetected`` out of ``run_elastic`` on every rank at
  the same step; the wrapper rolls back to the newest verified checkpoint
  and re-enters on the surviving hosts (``initial_hosts``) — compound
  scenarios where a rack dies *during* an SDC storm recover end to end.

- ``ServeScenarioDriver`` replays the same trace against a running
  ``ServeEngine``: kills become ``schedule_replica_kill`` (several ids at
  one step = a correlated rack loss), SDC storms become
  ``schedule_replica_sdc`` (the sentinel drain path), straggles become
  latency spikes, partitions gate replica emitters, and traffic spikes
  multiply the driver's own request arrivals (flash crowd).  The driver
  records conservation samples every engine step so
  ``invariants.check_conservation`` / ``check_monotonic_drain`` audit the
  whole run.

One process a rank: every rank compiles the same (deterministic)
scenario, and a host's action fires in the process that holds the host's
heartbeat emitter (its leader rank), from ``on_metrics`` while the rank
is in the mesh, or from ``on_idle`` when the mesh's boundary cue reaches
it through the run's store.  Rank 0 holds its verdict at the action's
boundary until the monitor has seen the effect (a kill or partition
declared, a rejoin pending), against a deadline — where the reference's
one process sleeps ``settle_seconds`` and hopes the timeout fired — so a
shrink or grow lands at the trace's step on every run.

Event kinds outside a plane (``traffic_spike`` for training, ``preempt``
for serving) are recorded in the driver's ``skipped`` report, never
silently lost.  All event clocks here are ``clock="step"``; virtual-time
scenarios belong to the simulator (``repro_torch.chaos.sim``).
"""
from __future__ import annotations

import os
import random
import signal as signal_module
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.chaos.scenario import Scenario, ScenarioError
from repro_torch.core.failures import CorruptionDetected, FaultInjector

# how long an action's boundary waits for the monitor to see its effect
# before it raises (the monitor's own timeout is a few seconds at most)
SETTLE_TIMEOUT = 120.0


def _emit_scenario(obs, scenario: Scenario, plane: str) -> None:
    """Record the compiled scenario declaratively on the bus: one
    ``chaos/<kind>`` event per scenario event (original at/until/args)
    plus a ``chaos/scenario`` meta event carrying name/clock/seed.
    ``repro_torch.obs.export.to_scenario`` reconstructs the Scenario
    losslessly from these — the record half of record-and-replay."""
    if obs is None:
        return
    obs.emit("chaos", "scenario", name=scenario.name,
             clock=scenario.clock, seed=scenario.seed, plane=plane)
    for ev in scenario.sorted_events():
        obs.emit("chaos", ev.kind, at=ev.at, until=ev.until, plane=plane,
                 **ev.args)


def _storm_flips(scenario: Scenario, event, leaf_names: Sequence[str]
                 ) -> List[Tuple[int, str, int]]:
    """Deterministic (step, leaf, bit) schedule for one sdc_storm event —
    seeded by (scenario.seed, event id), so replays, ranks and both
    planes agree."""
    leaves = event.args["leaves"] or list(leaf_names)
    if not leaves:
        raise ScenarioError(
            "sdc_storm: no target leaves — the event names none and the "
            "driver was given no leaf_names")
    rng = random.Random(f"{scenario.seed}/storm/{event.eid}")
    flips = []
    for step in range(int(event.at), int(event.until)):
        if rng.random() < event.args["rate"]:
            flips.append((step, rng.choice(list(leaves)),
                          rng.randrange(event.args["max_bit"])))
    return flips


class TrainScenarioDriver:
    """Compile a Scenario for the elastic training loop.

    - ``emitters``: host id -> ``HeartbeatEmitter`` this process holds
      (in one process every host's; on a rank mesh the hosts the rank
      leads, host 0's being rank 0's ``dep.emitter``).
    - ``hosts``: the run's host ids (default: ``emitters``' keys); a
      scenario touching another host is refused.  An action on a host
      whose emitter this process lacks fires in the process that has it.
    - ``preempts``: whether ``preempt`` signals this process (on a mesh,
      rank 0's: its facade's termination detection decides the pause).
    - ``leaf_names``: dotted state-leaf names sdc_storm flips pick from
      when the event doesn't name its own.
    - ``step_seconds``: the expected superstep duration straggle factors
      convert against.

    Wire ``on_metrics`` into ``run_bsp``/``run_elastic``; injector-borne
    events (flips, straggles) are scheduled at construction.  Actions fire
    once: a rollback replaying earlier steps does not re-kill a host.
    """

    def __init__(self, scenario: Scenario, *,
                 injector: Optional[FaultInjector] = None,
                 emitters: Optional[Dict[int, Any]] = None,
                 hosts: Optional[Sequence[int]] = None,
                 preempts: bool = True,
                 monitor_host: int = 0,
                 leaf_names: Sequence[str] = (),
                 step_seconds: float = 0.05,
                 obs=None):
        if scenario.clock != "step":
            raise ScenarioError(
                f"training driver needs clock='step', scenario "
                f"{scenario.name!r} uses {scenario.clock!r}")
        scenario.validate()
        self.scenario = scenario
        self.obs = obs
        self.injector = injector if injector is not None else FaultInjector()
        if obs is not None and self.injector.obs is None:
            self.injector.obs = obs
        self.emitters = dict(emitters or {})
        self.hosts = set(self.emitters if hosts is None else hosts)
        self.preempts = preempts
        self.monitor_host = monitor_host
        self.skipped: List[str] = []
        self.applied: List[Dict] = []          # chronological action log
        self._records: Dict[int, Dict] = {}    # step -> newest metrics rec
        self._fired: set = set()               # (eid, phase) already fired
        # (step, eid, phase, hosts, fn) boundary actions, step-ordered;
        # ``hosts`` the hosts the action touches (None: preempt)
        self._actions: List[Tuple[int, int, str, Optional[List[int]],
                                  Callable[[], None]]] = []
        self._compile(leaf_names, step_seconds)
        self._actions.sort(key=lambda a: (a[0], a[1]))
        _emit_scenario(self.obs, scenario, plane="train")

    # ------------------------------------------------------------------
    # compilation
    # ------------------------------------------------------------------
    def _check_host(self, host: int) -> None:
        if host not in self.hosts:
            raise ScenarioError(
                f"scenario {self.scenario.name!r} touches host {host} but "
                f"no emitter was provided (have {sorted(self.hosts)})")

    def _compile(self, leaf_names, step_seconds) -> None:
        for ev in self.scenario.sorted_events():
            if ev.kind == "kill_hosts":
                for h in ev.args["hosts"]:
                    self._check_host(h)        # fail fast on bad ids
                self._action(int(ev.at), ev.eid, "kill", ev.args["hosts"],
                             self._make_kill(ev.args["hosts"]))
            elif ev.kind == "rejoin":
                self._check_host(ev.args["host"])
                self._action(int(ev.at), ev.eid, "rejoin",
                             [ev.args["host"]], self._make_rejoin(ev))
            elif ev.kind == "partition":
                for g in ev.args["groups"]:
                    for h in g:
                        self._check_host(h)
                gated = self.gated_hosts(ev)
                self._action(int(ev.at), ev.eid, "partition", gated,
                             self._make_partition(ev))
                self._action(int(ev.until), ev.eid, "heal", gated,
                             self._make_heal(ev))
            elif ev.kind == "preempt":
                self._action(int(ev.at), ev.eid, "preempt", None,
                             self._make_preempt(ev))
            elif ev.kind == "sdc_storm":
                for step, leaf, bit in _storm_flips(self.scenario, ev,
                                                    leaf_names):
                    self.injector.schedule_bitflip(step, leaf, bit)
            elif ev.kind == "straggle":
                extra = (ev.args["factor"] - 1.0) * step_seconds
                for step in range(int(ev.at), int(ev.until)):
                    self.injector.schedule_straggle(step, extra)
            elif ev.kind == "precursor_storm":
                # symptom: the host straggles over [at, until) ...
                self._check_host(ev.args["host"])
                extra = (ev.args["factor"] - 1.0) * step_seconds
                for step in range(int(ev.at), int(ev.until)):
                    self.injector.schedule_straggle(step, extra)
                # ... then the predicted failure lands AT the window end
                if ev.args["kill"]:
                    self._action(int(ev.until), ev.eid, "kill",
                                 [ev.args["host"]],
                                 self._make_kill([ev.args["host"]]))
            else:
                self.skipped.append(ev.kind)

    def _action(self, at, eid, phase, hosts, fire) -> None:
        self._actions.append((at, eid, phase,
                              None if hosts is None else list(hosts), fire))

    def gated_hosts(self, ev) -> List[int]:
        """Hosts whose datagrams the partition drops: every group not
        containing the monitor host (the monitor's own side keeps
        delivering)."""
        groups = ev.args["groups"]
        keep = next((g for g in groups if self.monitor_host in g),
                    groups[0])
        return [h for g in groups if g is not keep for h in g]

    def _held(self, hosts) -> List[Any]:
        """The emitters of ``hosts`` that this process holds."""
        return [self.emitters[h] for h in hosts if h in self.emitters]

    def _make_kill(self, hosts):
        def fire():
            for em in self._held(hosts):
                em.pause()
        return fire

    def _make_rejoin(self, ev):
        def fire():
            for em in self._held([ev.args["host"]]):
                em.resume()
        return fire

    def _make_partition(self, ev):
        def fire():
            for em in self._held(self.gated_hosts(ev)):
                em.send_filter = lambda payload: False
        return fire

    def _make_heal(self, ev):
        def fire():
            for em in self._held(self.gated_hosts(ev)):
                em.send_filter = None
        return fire

    def _make_preempt(self, ev):
        def fire():
            if self.preempts:
                os.kill(os.getpid(), getattr(signal_module, ev.args["sig"]))
        return fire

    # ------------------------------------------------------------------
    # runtime
    # ------------------------------------------------------------------
    def actions(self) -> List[Tuple[int, int, str, Optional[List[int]]]]:
        """The boundary actions, ``(at, event id, phase, hosts)`` in step
        order (``hosts`` None for preempt)."""
        return [(at, eid, phase, hosts)
                for at, eid, phase, hosts, _ in self._actions]

    def fire(self, step: int, eid: int, phase: str) -> bool:
        """Fire one boundary action in this process, once: this process's
        part of it (the emitters it holds).  False if it had fired."""
        key = (eid, phase)
        if key in self._fired:
            return False
        at, fn = next((a[0], a[4]) for a in self._actions
                      if a[1] == eid and a[2] == phase)
        self._fired.add(key)
        self.applied.append({"step": step, "at": at, "phase": phase,
                             "event": eid})
        if self.obs is not None:
            self.obs.emit("chaos", "applied", step=step, at=at,
                          phase=phase, event=eid)
        fn()
        return True

    def on_metrics(self, step: int, rec: Dict) -> None:
        """Chain into the BSP loop's ``on_metrics``: fires every due
        boundary action exactly once and keeps the newest metrics record
        per step (a replay after rollback overwrites the corrupted-era
        record, so the merged trajectory is the one that survived)."""
        self._records[step] = rec
        if self.obs is not None:
            self.obs.emit("chaos", "record", **rec)
        for at, eid, phase, _, _ in self._actions:
            if at > step:
                break
            self.fire(step, eid, phase)

    def history(self) -> List[Dict]:
        """Merged per-step metrics records, step-ordered (newest record
        wins for steps replayed after a rollback).  With ``obs`` attached
        the records live on the bus ("chaos"/"record"); newest-per-step
        still wins because later emits overwrite earlier steps' entries
        in the reconstruction."""
        if self.obs is not None:
            recs: Dict[int, Dict] = {}
            for e in self.obs.events(subsystem="chaos", kind="record"):
                recs[e.data["step"]] = dict(e.data)
            # the bus ring is bounded: records that fell off the front are
            # still in the local dict — merge, bus (newer) wins
            merged = dict(self._records)
            merged.update(recs)
            return [merged[s] for s in sorted(merged)]
        return [self._records[s] for s in sorted(self._records)]

    def dead_intervals(self) -> Dict[int, List[Tuple[float, float]]]:
        """host -> [(t_kill, t_rejoin_or_inf)] from the scenario timeline
        (for ``invariants.check_no_dead_growth``)."""
        out: Dict[int, List[Tuple[float, float]]] = {}
        open_at: Dict[int, float] = {}
        kills: List[Tuple[float, int]] = []    # (effective time, host)
        for ev in self.scenario.sorted_events():
            if ev.kind == "kill_hosts":
                kills.extend((ev.at, h) for h in ev.args["hosts"])
            elif ev.kind == "precursor_storm" and ev.args["kill"]:
                kills.append((ev.until, ev.args["host"]))
        rejoins = [(ev.at, ev.args["host"])
                   for ev in self.scenario.point_events("rejoin")]
        marks = ([(t, 0, h) for t, h in kills]
                 + [(t, 1, h) for t, h in rejoins])
        for t, action, h in sorted(marks):
            if action == 0:
                open_at[h] = t
            else:
                if h in open_at:
                    out.setdefault(h, []).append((open_at.pop(h), t))
        for h, t0 in open_at.items():
            out.setdefault(h, []).append((t0, float("inf")))
        return out

    def report(self) -> Dict:
        return {"scenario": self.scenario.name,
                "applied": list(self.applied),
                "skipped": sorted(set(self.skipped)),
                "pending_injections": len(self.injector.pending()),
                "sdc_injected": list(self.injector.sdc_injected)}


class _Cues:
    """The driver's actions over a rank mesh.  Mesh ranks fire their part
    from ``on_metrics``; rank 0, at each superstep boundary before its
    verdict, publishes a cue for every due action (so a host outside the
    mesh, which runs no superstep, fires its part from ``on_idle``) and
    waits until the monitor has seen the action's effect."""

    def __init__(self, driver: TrainScenarioDriver, dep, world, run: str,
                 alive: Callable[[], List[int]]):
        self.driver, self.dep, self.world = driver, dep, world
        self.key = f"chaos/{run}/cue/"
        self.alive = alive
        self.settled: set = set()

    def on_idle(self) -> None:
        d = self.driver
        for at, eid, phase, hosts in d.actions():
            if (eid, phase) in d._fired or not self.world.has(
                    f"{self.key}{eid}/{phase}"):
                continue
            if hosts is None or any(h in d.emitters for h in hosts):
                step = int(self.world.fetch(f"{self.key}{eid}/{phase}"))
                d.fire(step, eid, phase)

    def on_boundary(self, step: int) -> None:
        """Rank 0, at boundary ``step`` (the state's step) before its
        verdict."""
        d = self.driver
        due = [a for a in d.actions() if a[0] <= step
               and (a[1], a[2]) not in self.settled]
        for at, eid, phase, hosts in due:
            self.world.publish(f"{self.key}{eid}/{phase}", str(step))
            d.fire(step, eid, phase)
        for at, eid, phase, hosts in due:
            self._wait(phase, hosts)
            self.settled.add((eid, phase))

    def _wait(self, phase: str, hosts) -> None:
        dep = self.dep
        alive = set(self.alive())
        if phase == "preempt":
            if dep.signals is None:
                return
            pred = dep.signals.triggered
            what = "the termination signal"
        elif phase in ("kill", "partition"):
            want = set(hosts) & alive

            def pred():
                return want <= (set(dep.monitor.failed_hosts())
                                | set(_pending(dep.on_host_failure)))
            what = f"hosts {sorted(want)} declared failed"
        else:                                  # rejoin, heal
            want = set(hosts) - alive

            def pred():
                return want <= set(_pending(dep.on_host_rejoin))
            what = f"hosts {sorted(want)} rejoining"
        deadline = time.monotonic() + SETTLE_TIMEOUT
        while not pred():
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank 0: {phase}: {what} not seen by "
                                   f"the monitor within {SETTLE_TIMEOUT} s")
            time.sleep(0.005)


def _pending(latch) -> List[int]:
    """The hosts an elastic-loop latch holds (none outside ``run_elastic``
    or when the callback is the user's own)."""
    pending = getattr(latch, "pending", None)
    return pending() if pending is not None else []


def run_scenario_elastic(dep, make_step, state, data, num_steps, *,
                         world,
                         scenario: Scenario,
                         emitters: Dict[int, Any],
                         host_devices: Dict[int, Sequence[int]],
                         model_axis: int = 1,
                         like=None,
                         shardings_fn: Optional[Callable] = None,
                         leaf_names: Sequence[str] = (),
                         step_seconds: float = 0.05,
                         max_rollbacks: int = 4,
                         on_metrics: Optional[Callable] = None,
                         on_event: Optional[Callable] = None,
                         on_idle: Optional[Callable[[], None]] = None,
                         obs=None,
                         **kw) -> Tuple[Any, Dict]:
    """Drive ``run_elastic`` through ``scenario`` on every rank of
    ``world``, surviving detected corruption by rolling back to the newest
    verified checkpoint and re-entering on the surviving hosts.

    - ``emitters``: host id -> the heartbeat emitters this rank holds
      (its host's, if it leads it; rank 0 includes ``dep.emitter`` as
      host 0's).  ``host_devices``: host id -> its ranks, as
      ``run_elastic`` takes it.
    - ``state``: the whole state or ``state(mesh, shardings)``, as
      ``run_elastic`` takes it; a rollback re-enters with the restore
      of each rank's shards on the new mesh.
    - ``on_idle``, ``mesh_spec``, ``degrade_experts`` and the rest of
      ``kw`` pass through to ``run_elastic``.

    Returns ``(state, info)`` on every rank (``state`` None outside the
    final mesh): ``info["history"]`` is the merged per-step trajectory
    (loss records, deduplicated across replays), ``info["events"]`` every
    ``MeshEvent`` across re-entries, ``info["rollbacks"]`` the
    corruption-recovery count, and ``info["report"]`` the driver's
    applied/skipped action log.
    """
    from repro_torch.core.elastic_loop import run_elastic

    if obs is None:
        obs = dep.obs                      # reuse an attached handle
    elif dep.obs is None:
        dep.attach_obs(obs)                # thread telemetry end to end
    driver = TrainScenarioDriver(
        scenario, emitters=emitters, hosts=list(host_devices),
        preempts=world.rank == 0, leaf_names=leaf_names,
        step_seconds=step_seconds, obs=obs)
    # a flip lands where the reference's lands in the global leaf: only
    # in the shards that hold its byte
    driver.injector.layout = lambda: (dep._global_template,
                                      dep._global_shardings)
    events: List[Any] = []
    alive = sorted(host_devices)
    run = world._next("chaos")
    cues = _Cues(driver, dep, world, run, lambda: alive)

    def chained_metrics(step, rec):
        driver.on_metrics(step, rec)
        if on_metrics is not None:
            on_metrics(step, rec)

    def chained_event(ev):
        events.append(ev)
        nonlocal alive
        if ev.kind == "shrink":
            alive = [h for h in alive if h not in ev.hosts]
        else:
            alive = sorted(set(alive) | set(ev.hosts))
        if on_event is not None:
            on_event(ev)

    def chained_idle():
        cues.on_idle()
        if on_idle is not None:
            on_idle()

    rollbacks = 0
    extra_history: List[Dict] = []
    while True:
        try:
            state, info = run_elastic(
                dep, make_step, state, data, num_steps, world=world,
                host_devices=host_devices, initial_hosts=alive,
                model_axis=model_axis, like=like, shardings_fn=shardings_fn,
                fault_injector=driver.injector, on_metrics=chained_metrics,
                on_event=chained_event, on_idle=chained_idle,
                on_boundary=cues.on_boundary if world.rank == 0 else None,
                **kw)
            break
        except CorruptionDetected as e:
            rollbacks += 1
            extra_history.append({
                "step": e.step, "event": f"corruption:{e.kind}:{e.detail}"})
            if rollbacks > max_rollbacks:
                raise
            state = None
            dep.manager.wait()
            # every rank's saves have landed and host 0 committed them
            world.barrier("chaos/rollback", poll=chained_idle)
            _agree_verified(dep, world, f"chaos/{run}/verified/{rollbacks}/")
            dep.reset_sdc()
            state = _restorer(dep, like, extra_history, obs, e.step,
                              rollbacks)
    merged = driver.history() + extra_history
    merged.extend(h for h in info["history"] if "event" in h)
    info = dict(info, events=events, rollbacks=rollbacks,
                history=sorted(merged, key=lambda h: h["step"]),
                report=driver.report())
    return state, info


def _agree_verified(dep, world, key: str) -> None:
    """Every rank takes the union of the ranks' scrub-verified saves: a
    rank that sat outside the mesh has not seen the saves since, and the
    rollback's restore must pick the same checkpoint on every rank."""
    world.publish(key + str(world.rank),
                  ",".join(map(str, sorted(dep.verified_steps))))
    ranks = range(world.size)
    world.wait_keys([key + str(r) for r in ranks], SETTLE_TIMEOUT)
    dep.verified_steps = {int(v) for r in ranks
                          for v in world.fetch(key + str(r)).split(",") if v}


def _restorer(dep, like, extra_history, obs, failed_at: int,
              rollbacks: int):
    """The state ``run_elastic`` re-enters with after a rollback: each
    rank of the first mesh restores its shards of the newest verified
    checkpoint."""
    def restore(mesh, shardings):
        state, got = dep.restore_latest(like=like, shardings=shardings)
        extra_history.append({"step": got, "event": f"rollback:{got}"})
        if obs is not None:
            # the re-entry IS the resume for this corruption incident
            obs.emit("train", "resume", step=got, rolled_back_from=failed_at,
                     rollbacks=rollbacks)
        return state
    return restore


class ServeScenarioDriver:
    """Replay a Scenario against a live ``ServeEngine``.

    The driver owns the workload: ``base_rate`` requests are submitted per
    engine step (deterministic prompts from ``scenario.seed``), multiplied
    by any active ``traffic_spike``.  ``QueueFull`` rejections are counted
    (admission control working as designed), never raised to the caller.

    Construction compiles injector-borne events (kills, SDC storms,
    straggle latency spikes) onto the engine's ``FaultInjector``;
    ``step``/``run`` fire partition gates at engine-step boundaries and
    record one conservation sample per step for the invariant checks.  A
    partition's gate holds the step until the engine's monitor has
    declared the cut replicas' hosts (the reference sleeps instead).
    """

    def __init__(self, engine, scenario: Scenario, *,
                 base_rate: int = 1,
                 prompt_len: int = 8,
                 max_new_tokens: int = 8,
                 step_seconds: float = 0.02):
        if scenario.clock != "step":
            raise ScenarioError(
                f"serve driver needs clock='step', scenario "
                f"{scenario.name!r} uses {scenario.clock!r}")
        scenario.validate()
        self.engine = engine
        self.scenario = scenario
        # the engine always owns an Observability; the driver records its
        # compiled scenario on the same bus so one log tells both stories
        self.obs = getattr(engine, "obs", None)
        self.base_rate = int(base_rate)
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        if engine.injector is None:
            engine.injector = FaultInjector()
        self.injector = engine.injector
        self.skipped: List[str] = []
        self.rejected = 0
        self.submitted_rids: List[int] = []
        self.prompts: Dict[int, List[int]] = {}   # rid -> prompt
        self.samples: List[Dict[str, int]] = []
        self.page_samples: List[Dict[str, int]] = []   # paged engines only
        self.drained_series: List[int] = []
        self._gates_on: set = set()
        self._prompt_rng = random.Random(f"{scenario.seed}/prompts")
        if self.obs is not None and self.injector.obs is None:
            self.injector.obs = self.obs
        self._compile(step_seconds)
        _emit_scenario(self.obs, scenario, plane="serve")

    # ------------------------------------------------------------------
    # compilation
    # ------------------------------------------------------------------
    def _compile(self, step_seconds: float) -> None:
        replica_ids = sorted(self.engine.router.replicas)
        rng = random.Random(f"{self.scenario.seed}/serve")
        for ev in self.scenario.sorted_events():
            if ev.kind == "kill_hosts":
                for rid in ev.args["hosts"]:
                    self.injector.schedule_replica_kill(int(ev.at), rid)
            elif ev.kind == "sdc_storm":
                # the storm strikes replicas here: rate per engine step,
                # victim drawn from the replicas present at compile time
                for step in range(int(ev.at), int(ev.until)):
                    if rng.random() < ev.args["rate"]:
                        self.injector.schedule_replica_sdc(
                            step, rng.choice(replica_ids),
                            detail=f"storm:{self.scenario.name}")
            elif ev.kind == "straggle":
                extra = (ev.args["factor"] - 1.0) * step_seconds
                for step in range(int(ev.at), int(ev.until)):
                    self.injector.schedule_latency_spike(
                        step, extra, replica_id=ev.args["host"])
            elif ev.kind == "precursor_storm":
                # symptom: latency spikes over the window; predicted
                # failure: the replica kill lands at the window end —
                # the pre-drain must beat it there
                extra = (ev.args["factor"] - 1.0) * step_seconds
                for step in range(int(ev.at), int(ev.until)):
                    self.injector.schedule_latency_spike(
                        step, extra, replica_id=ev.args["host"])
                if ev.args["kill"]:
                    self.injector.schedule_replica_kill(
                        int(ev.until), ev.args["host"])
            elif ev.kind in ("partition", "traffic_spike"):
                pass                       # fired/queried at step time
            else:
                self.skipped.append(ev.kind)

    # ------------------------------------------------------------------
    # workload
    # ------------------------------------------------------------------
    def _make_prompt(self) -> List[int]:
        vocab = self.engine.cfg.vocab_size
        return [self._prompt_rng.randrange(vocab)
                for _ in range(self.prompt_len)]

    def arrival_rate(self, step: int) -> int:
        """Requests to submit at ``step``: base rate x any active spike.
        The workload lasts through the scenario horizon — past it arrivals
        stop, so ``run`` can drain to completion."""
        if step > self.scenario.horizon:
            return 0
        mult = 1.0
        for ev in self.scenario.active(step, "traffic_spike"):
            mult = max(mult, ev.args["mult"])
        return int(round(self.base_rate * mult))

    def _fire_partitions(self, step: int) -> None:
        for ev in self.scenario.window_events("partition"):
            on = ev.active(step)
            if on and ev.eid not in self._gates_on:
                self._gates_on.add(ev.eid)
                cut = []
                for rid in self._partitioned(ev):
                    rep = self.engine.router.replicas.get(rid)
                    if rep is not None and rep.emitter is not None:
                        rep.emitter.send_filter = lambda payload: False
                        cut.extend(rep.hosts)
                # the monitor's timeout lands inside the window
                self._declared(cut)
            elif not on and ev.eid in self._gates_on and step >= ev.until:
                self._gates_on.discard(ev.eid)
                for rid in self._partitioned(ev):
                    rep = self.engine.router.replicas.get(rid)
                    if rep is not None and rep.emitter is not None:
                        rep.emitter.send_filter = None

    def _partitioned(self, ev) -> List[int]:
        """Replicas the partition cuts off from the monitor: every group
        but the first (the monitor's side)."""
        return [r for g in ev.args["groups"][1:] for r in g]

    def _declared(self, hosts: Sequence[int]) -> None:
        """Wait until the monitor has declared ``hosts`` failed."""
        mon = self.engine.monitor
        if mon is None or not hosts:
            return
        deadline = time.monotonic() + SETTLE_TIMEOUT
        while not set(hosts) <= set(mon.failed_hosts()):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"partition: hosts {sorted(hosts)} not declared by the "
                    f"monitor within {SETTLE_TIMEOUT} s")
            time.sleep(0.005)

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def step(self) -> None:
        from repro_torch.serve.scheduler import QueueFull

        estep = self.engine.engine_step
        self._fire_partitions(estep)
        for _ in range(self.arrival_rate(estep)):
            prompt = self._make_prompt()
            try:
                rid = self.engine.submit(prompt, self.max_new_tokens)
            except QueueFull:
                self.rejected += 1
                continue
            self.submitted_rids.append(rid)
            self.prompts[rid] = prompt
        self.engine.step()
        self._sample()

    def _sample(self) -> None:
        sched = self.engine.scheduler
        terminal = sum(1 for r in sched.requests.values()
                       if r.state in ("DONE", "FAILED"))
        self.samples.append({
            "submitted": sched._next_rid,
            "completed": terminal,
            "queued": sched.pending(),
            "in_flight": len(sched.in_flight()),
        })
        if getattr(self.engine, "paged", False):
            # page accounting rides along every request-conservation
            # sample: free + held == total and refcounts consistent at
            # every step, across kills and drains (check_page_conservation)
            self.page_samples.append(self.engine.page_conservation())
        self.drained_series.append(len(sched.retried_rids))

    def run(self, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Step until the scenario horizon has passed AND every request is
        done; returns rid -> tokens.  ``max_steps`` guards liveness."""
        if max_steps is None:
            max_steps = int(4 * self.scenario.horizon + 200
                            + 8 * self.max_new_tokens
                            * max(self.base_rate, 1))
        start = self.engine.engine_step
        while (self.engine.engine_step <= self.scenario.horizon
               or not self.engine.scheduler.all_done()):
            if self.engine.engine_step - start > max_steps:
                raise RuntimeError(
                    f"scenario {self.scenario.name!r} did not drain after "
                    f"{max_steps} engine steps")
            self.step()
        return self.engine.results()

    def report(self) -> Dict:
        return {"scenario": self.scenario.name,
                "submitted": len(self.submitted_rids),
                "rejected": self.rejected,
                "retried": len(set(self.engine.scheduler.retried_rids)),
                "skipped": sorted(set(self.skipped)),
                "pending_injections": len(self.injector.pending())}
