"""Cluster-scale control-plane simulator (the reference's
``chaos/sim.py``): the heartbeat / policy / mesh / drain logic at
thousands of hosts, with no devices and no real clock.

The real stack caps out at what one machine can host (a few rank
processes, a handful of UDP emitters).  The decisions the dependability
layer makes, though — who is dead, what mesh survives, how the checkpoint
cadence tracks fleet size, whether a stale datagram can resurrect a
corpse — are pure control-plane logic.  ``ControlPlaneSim`` re-implements
the *protocol* (the same (inc, seq) beat ordering as ``core/heartbeat.py``,
the same ``largest_grid`` / ``best_grid3d`` mesh selection, the real
``CheckpointPolicy`` object) on a synthetic tick clock, so a scenario can
be replayed against 1000+ virtual hosts in well under a minute:

- **liveness**: every alive, un-partitioned host delivers one beat per
  tick; the monitor model times hosts out after ``timeout_factor`` beat
  periods, exactly like ``HeartbeatMonitor``.  Detection latency (kill ->
  declared dead) is recorded per failure.
- **stale rejoin ordering**: a kill strands a few in-flight datagrams
  carrying the dead host's old (inc, seq); they deliver AFTER the host
  was excluded and must be rejected — a rejoin requires a beat ordered
  after the last accepted one, and a real rejoin bumps ``inc`` (emitter
  lifetime), so only a genuinely restarted host grows the mesh.
- **mesh selection**: each exclusion/rejoin rebuilds the member set and
  recomputes the (data, model) grid via the real ``largest_grid``.
- **Young/Daly cadence**: the real ``CheckpointPolicy`` is re-sized at
  every membership change (``system.num_nodes`` follows the mesh) and its
  ``interval_steps`` is checked tick-by-tick against the closed-form
  ``young_daly_period`` — the cadence must track fleet MTBF as the fleet
  shrinks and regrows.
- **drain/requeue accounting**: a serve-plane queue model (arrivals x
  traffic-spike multiplier, per-host slots, fixed service time) drains a
  dead host's in-flight work back to the queue; ``invariants``'
  conservation and monotonic-drain checks audit every tick.

Plain Python, no tensors: its ``SimReport`` equals the reference's field
for field (``wall_seconds`` aside) on the same scenario and arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.chaos import invariants as inv
from repro_torch.chaos.scenario import Scenario, ScenarioError
from repro_torch.core.elastic import (MeshSpec, NoSurvivorsError,
                                      best_grid3d, largest_grid)
from repro_torch.core.policy import (CheckpointPolicy, SystemModel,
                                     young_daly_period)


def _pctl(xs, q: float) -> float:
    """Nearest-rank percentile (same convention as ``serve.engine.pctl``,
    re-stated here so the simulator stays import-light)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else 0.0


@dataclasses.dataclass
class _Host:
    alive: bool = True
    inc: int = 1          # emitter lifetime — bumps on every restart
    seq: int = 0
    t_killed: Optional[float] = None


@dataclasses.dataclass
class SimReport:
    name: str
    num_hosts: int
    ticks: int
    wall_seconds: float
    detections: List[Dict]            # {"host", "t_lost", "t_detected"}
    grow_events: List[Tuple[float, List[int]]]
    stale_delivered: int
    stale_rejected: int
    mesh_history: List[Dict]          # {"t", "members", "dp", "mp"}
    cadence: List[Dict]               # {"t", "nodes", "interval", "expected"}
    invariants: List[inv.InvariantResult]
    drained_total: int
    completed_total: int

    @property
    def detection_latencies(self) -> List[float]:
        return [d["t_detected"] - d["t_lost"] for d in self.detections]

    @property
    def cadence_ok(self) -> bool:
        return all(c["interval"] == c["expected"] for c in self.cadence)

    def to_dict(self) -> Dict:
        lat = self.detection_latencies
        return {
            "name": self.name,
            "num_hosts": self.num_hosts,
            "ticks": self.ticks,
            "wall_seconds": round(self.wall_seconds, 3),
            "detected": len(self.detections),
            "detection_latency_p50": _pctl(lat, 0.50),
            "detection_latency_p99": _pctl(lat, 0.99),
            "grow_events": len(self.grow_events),
            "stale_delivered": self.stale_delivered,
            "stale_rejected": self.stale_rejected,
            "mesh_changes": len(self.mesh_history),
            "final_dp": (self.mesh_history[-1]["dp"]
                         if self.mesh_history else None),
            "cadence_checks": len(self.cadence),
            "cadence_ok": self.cadence_ok,
            "drained": self.drained_total,
            "completed": self.completed_total,
            "invariants": inv.summarize(self.invariants),
            "invariant_pass_rate": inv.pass_rate(self.invariants),
        }


class ControlPlaneSim:
    """See the module docstring.  ``devices_per_host`` sizes the grid the
    mesh selection reasons over; serve-plane knobs (``base_rate``,
    ``slots_per_host``, ``service_ticks``) shape the drain model."""

    def __init__(self, num_hosts: int, *,
                 period: float = 0.1,
                 timeout_factor: float = 5.0,
                 devices_per_host: int = 1,
                 model_axis: int = 1,
                 mesh_spec: Optional[MeshSpec] = None,
                 monitor_host: int = 0,
                 stale_in_flight: int = 3,
                 stale_delay_ticks: int = 2,
                 node_mtbf_seconds: float = 3.15e7,
                 ckpt_cost_s: float = 30.0,
                 step_time_s: float = 1.0,
                 base_rate: int = 0,
                 slots_per_host: int = 4,
                 service_ticks: int = 3):
        if num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
        self.num_hosts = num_hosts
        self.period = period
        self.timeout = timeout_factor * period
        self.devices_per_host = devices_per_host
        self.model_axis = model_axis
        # 3D mode: mesh selection runs the real best_grid3d factorization
        # (legal tp widths, ep | experts, ep -> dp -> tp degradation) and
        # every host gets (dp, tp, ep) coordinates — the 1000-host traces
        # validate the same shrink protocol run_elastic executes on devices
        self.mesh_spec = mesh_spec
        self.monitor_host = monitor_host
        self.stale_in_flight = stale_in_flight
        self.stale_delay_ticks = stale_delay_ticks
        self.node_mtbf_seconds = node_mtbf_seconds
        self.ckpt_cost_s = ckpt_cost_s
        self.step_time_s = step_time_s
        self.base_rate = base_rate
        self.slots_per_host = slots_per_host
        self.service_ticks = service_ticks

    # ------------------------------------------------------------------
    # axis-aware host coordinates (3D mode)
    # ------------------------------------------------------------------
    def host_coords(self, members=None) -> Dict[int, Tuple[int, int, int]]:
        """host id -> (data, model, expert) coordinate of its FIRST device
        under the current members' best legal grid.  Placement matches
        ``core.elastic.survivor_mesh3d`` exactly — expert-major, hosts own
        contiguous device ranges — so a trace replayed here excludes the
        same expert slice the device-backed loop would.  Hosts whose
        devices fall off the grid (n not a multiple of dp*tp*ep) map to
        no coordinate and are omitted."""
        if self.mesh_spec is None:
            raise ValueError("host_coords requires mesh_spec (3D mode)")
        live = sorted(range(self.num_hosts) if members is None else members)
        n = len(live) * self.devices_per_host
        dp, tp, ep = best_grid3d(n, self.mesh_spec)
        out: Dict[int, Tuple[int, int, int]] = {}
        for pos, h in enumerate(live):
            v = pos * self.devices_per_host      # first device's flat index
            if v >= dp * tp * ep:
                continue
            k, rem = divmod(v, dp * tp)
            i, j = divmod(rem, tp)
            out[h] = (i, j, k)
        return out

    def _legal_grid_entry(self, m: Dict) -> bool:
        spec = self.mesh_spec
        dp, tp, ep = m["dp"], m["mp"], m.get("ep", 1)
        n = m["members"] * self.devices_per_host
        if dp * tp * ep > n or min(dp, tp, ep) < 1:
            return False
        if spec.legal_model is not None and tp not in spec.legal_model:
            return False
        if spec.num_experts and spec.num_experts % ep:
            return False
        return tp <= spec.model and ep <= max(spec.expert, 1)

    # ------------------------------------------------------------------
    # clock
    # ------------------------------------------------------------------
    def _tick_of(self, at: float, clock: str) -> int:
        """Scenario event time -> tick index.  clock='step': one superstep
        per tick; clock='time': virtual seconds over the beat period."""
        return int(at) if clock == "step" else int(round(at / self.period))

    # ------------------------------------------------------------------
    # the run
    # ------------------------------------------------------------------
    def run(self, scenario: Scenario, extra_ticks: Optional[int] = None
            ) -> SimReport:
        import time as _time
        scenario.validate()
        t_wall = _time.perf_counter()
        clock = scenario.clock
        if extra_ticks is None:
            # past the horizon: room for the timeout to expire and the
            # queue to drain
            extra_ticks = (int(self.timeout / self.period) + 2
                           + 4 * self.service_ticks + 4)
        ticks = self._tick_of(scenario.horizon, clock) + extra_ticks

        hosts = [_Host() for _ in range(self.num_hosts)]
        # monitor model state (mirrors HeartbeatMonitor fields)
        last_beat: Dict[int, Tuple[int, int]] = {}
        last_seen: Dict[int, float] = {}
        excluded: set = set()
        failed: set = set()
        members = set(range(self.num_hosts))

        # scenario events, pre-bucketed by tick
        kills: Dict[int, List[int]] = {}
        rejoins: Dict[int, List[int]] = {}
        for ev in scenario.point_events("kill_hosts"):
            for h in ev.args["hosts"]:
                if not 0 <= h < self.num_hosts:
                    raise ScenarioError(
                        f"kill_hosts targets host {h}; sim has "
                        f"{self.num_hosts}")
                kills.setdefault(self._tick_of(ev.at, clock), []).append(h)
        for ev in scenario.window_events("precursor_storm"):
            # the straggle itself is invisible to the control plane (the
            # host keeps beating); the deferred kill is not
            if not ev.args["kill"]:
                continue
            h = ev.args["host"]
            if not 0 <= h < self.num_hosts:
                raise ScenarioError(
                    f"precursor_storm targets host {h}; sim has "
                    f"{self.num_hosts}")
            kills.setdefault(self._tick_of(ev.until, clock),
                             []).append(h)
        for ev in scenario.point_events("rejoin"):
            rejoins.setdefault(self._tick_of(ev.at, clock), []).append(
                ev.args["host"])
        partitions = [(self._tick_of(ev.at, clock),
                       self._tick_of(ev.until, clock), ev.args["groups"])
                      for ev in scenario.window_events("partition")]
        spikes = [(self._tick_of(ev.at, clock),
                   self._tick_of(ev.until, clock), ev.args["mult"])
                  for ev in scenario.window_events("traffic_spike")]
        # datagrams stranded in flight: (deliver_tick, host, inc, seq)
        stale_queue: List[Tuple[int, int, int, int]] = []

        policy = CheckpointPolicy(
            mode="young_daly",
            system=SystemModel(node_mtbf_seconds=self.node_mtbf_seconds,
                               num_nodes=len(members)))
        policy.observe_step(self.step_time_s)
        policy.observe_checkpoint(self.ckpt_cost_s)

        detections: List[Dict] = []
        grow_events: List[Tuple[float, List[int]]] = []
        mesh_history: List[Dict] = []
        cadence: List[Dict] = []
        stale_delivered = stale_rejected = 0
        dead_intervals: Dict[int, List[Tuple[float, float]]] = {}
        dead_open: Dict[int, float] = {}

        # serve-plane drain model
        queued = in_flight_n = completed = submitted = 0
        host_flight: Dict[int, List[int]] = {h: [] for h in members}
        drained_series: List[int] = []
        drained_total = 0
        samples: List[Dict[str, int]] = []

        def record_mesh(now: float) -> None:
            n = len(members) * self.devices_per_host
            if self.mesh_spec is not None:
                dp, mp, ep = best_grid3d(n, self.mesh_spec)
            else:
                dp, mp = largest_grid(n, self.model_axis)
                ep = 1
            mesh_history.append({"t": now, "members": len(members),
                                 "dp": dp, "mp": mp, "ep": ep})
            policy.system.num_nodes = len(members)

        def dropped_by_partition(h: int, tick: int) -> bool:
            for t0, t1, groups in partitions:
                if t0 <= tick < t1:
                    keep = next((g for g in groups
                                 if self.monitor_host in g), groups[0])
                    if any(h in g for g in groups if g is not keep):
                        return True
            return False

        def accept_beat(h: int, inc: int, seq: int, now: float) -> bool:
            """The (inc, seq) ordering rule of ``HeartbeatMonitor``: a
            beat counts only if strictly newer than the last accepted."""
            if last_beat.get(h, (0, -1)) >= (inc, seq):
                return False
            last_beat[h] = (inc, seq)
            last_seen[h] = now
            return True

        record_mesh(0.0)
        for tick in range(ticks):
            now = tick * self.period

            # -- scenario events due this tick --------------------------
            for h in kills.get(tick, ()):
                host = hosts[h]
                if not host.alive:
                    continue
                host.alive = False
                host.t_killed = now
                dead_open[h] = now
                # strand the last few datagrams "on the wire"
                for k in range(self.stale_in_flight):
                    stale_queue.append(
                        (tick + self.stale_delay_ticks + k, h,
                         host.inc, max(host.seq - k, 0)))
            for h in rejoins.get(tick, ()):
                host = hosts[h]
                if host.alive:
                    continue
                host.alive = True
                host.inc += 1     # emitter restart stamps a new lifetime
                host.seq = 0
                host.t_killed = None
                if h in dead_open:
                    dead_intervals.setdefault(h, []).append(
                        (dead_open.pop(h), now))

            # -- beat delivery ------------------------------------------
            for h, host in enumerate(hosts):
                if not host.alive:
                    continue
                host.seq += 1
                if dropped_by_partition(h, tick):
                    continue      # seq advanced, datagram lost: asymmetric
                newer = accept_beat(h, host.inc, host.seq, now)
                if newer and h in excluded:
                    # ordered-after-exclusion beat: genuine rejoin
                    excluded.discard(h)
                    failed.discard(h)
                    members.add(h)
                    host_flight[h] = []
                    grow_events.append((now, [h]))
                    record_mesh(now)

            # -- stale in-flight datagrams ------------------------------
            still = []
            for due, h, inc, seq in stale_queue:
                if due != tick:
                    still.append((due, h, inc, seq))
                    continue
                stale_delivered += 1
                if not accept_beat(h, inc, seq, now):
                    stale_rejected += 1
                elif h in excluded:
                    # accepted AND excluded would be a protocol hole: a
                    # corpse grew the mesh (check_no_dead_growth flags it)
                    excluded.discard(h)
                    members.add(h)
                    grow_events.append((now, [h]))
                    record_mesh(now)
            stale_queue = still

            # -- timeout detection --------------------------------------
            for h in sorted(members):
                if h in failed or h in excluded:
                    continue
                seen = last_seen.get(h, 0.0)
                if now - seen > self.timeout:
                    failed.add(h)
                    host = hosts[h]
                    t_lost = (host.t_killed if host.t_killed is not None
                              else seen)
                    detections.append({"host": h, "t_lost": t_lost,
                                       "t_detected": now})

            # -- control plane: acknowledge + shrink --------------------
            newly = sorted(failed - excluded)
            if newly:
                for h in newly:
                    excluded.add(h)
                    members.discard(h)
                    # drain the dead host's in-flight work to the queue
                    lost = host_flight.pop(h, [])
                    drained_total += len(lost)
                    queued += len(lost)
                    in_flight_n -= len(lost)
                if not members:
                    raise NoSurvivorsError(
                        f"sim: every host dead at t={now}")
                record_mesh(now)

            # -- Young/Daly cadence check -------------------------------
            interval = policy.interval_steps()
            t_opt = young_daly_period(
                self.node_mtbf_seconds / max(len(members), 1),
                self.ckpt_cost_s, policy.system.restart_seconds,
                policy.system.downtime_seconds, formula=policy.formula)
            expected = max(policy.min_interval,
                           min(int(round(t_opt / self.step_time_s)),
                               policy.max_interval))
            cadence.append({"t": now, "nodes": len(members),
                            "interval": interval, "expected": expected})

            # -- serve-plane queue model --------------------------------
            if self.base_rate:
                mult = 1.0
                for t0, t1, m in spikes:
                    if t0 <= tick < t1:
                        mult = max(mult, m)
                arrivals = int(round(self.base_rate * mult))
                submitted += arrivals
                queued += arrivals
                # completions first (frees slots), then admissions
                for h in sorted(members):
                    fl = host_flight.setdefault(h, [])
                    done = [d for d in fl if d <= tick]
                    completed += len(done)
                    in_flight_n -= len(done)
                    host_flight[h] = [d for d in fl if d > tick]
                for h in sorted(members):
                    fl = host_flight[h]
                    while queued and len(fl) < self.slots_per_host:
                        fl.append(tick + self.service_ticks)
                        queued -= 1
                        in_flight_n += 1
                drained_series.append(drained_total)
                samples.append({"submitted": submitted,
                                "completed": completed,
                                "queued": queued,
                                "in_flight": in_flight_n})

        for h, t0 in dead_open.items():
            dead_intervals.setdefault(h, []).append((t0, float("inf")))

        checks = [inv.check_no_dead_growth(grow_events, dead_intervals),
                  inv.check_monotonic_drain(drained_series)]
        if samples:
            checks.append(inv.check_conservation(samples))
        if self.mesh_spec is not None:
            bad = [m for m in mesh_history
                   if not self._legal_grid_entry(m)]
            checks.append(inv.InvariantResult(
                "legal-3d-grid", not bad,
                (f"{len(bad)} illegal grids: {bad[:3]}" if bad else
                 f"{len(mesh_history)} grids legal under "
                 f"(tp|heads, ep|experts)")))
        if not self.cadence_tolerated(cadence):
            checks.append(inv.InvariantResult(
                "young-daly-cadence", False,
                "policy interval diverged from closed form"))
        else:
            checks.append(inv.InvariantResult(
                "young-daly-cadence", True,
                f"{len(cadence)} ticks track eq. (1)"))

        return SimReport(
            name=scenario.name, num_hosts=self.num_hosts, ticks=ticks,
            wall_seconds=_time.perf_counter() - t_wall,
            detections=detections, grow_events=grow_events,
            stale_delivered=stale_delivered, stale_rejected=stale_rejected,
            mesh_history=mesh_history, cadence=cadence, invariants=checks,
            drained_total=drained_total, completed_total=completed)

    @staticmethod
    def cadence_tolerated(cadence: List[Dict]) -> bool:
        return all(c["interval"] == c["expected"] for c in cadence)
