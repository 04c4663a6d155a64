"""Elastic failover loop: heartbeat-driven mesh shrink/grow around the BSP
coordinator (the reference's ``core/elastic_loop.py``, one process a
rank).

- ``core/heartbeat.py`` detects a dead host (no beats within the
  timeout); rank 0 runs the monitor, and the monitor's ``on_failure`` /
  ``on_rejoin`` callbacks latch the host.
- ``core/elastic.py`` rebuilds a ``(data, model)`` or ``(data, model,
  expert)`` mesh from the survivors, and the checkpoint reshards onto it
  (span-based region reads in ``core/checkpoint.py``).

Every rank of the run calls ``run_elastic``.  A host is a group of ranks
(``launch.mesh.host_device_map``); its fail-stop is its heartbeat
emitter pausing, and its processes stay alive to rejoin.  Rank 0 owns
the monitor and decides at each superstep boundary: its verdict
(continue, or the reason to pause) reaches every rank of the mesh
through the run's store, so all ranks pause at the same step, take the
final save together (each its own shards) and learn the same event
(hosts failed or rejoined).  Each new mesh is a fresh ``DeviceMesh`` and
process groups over the survivors' ranks (``Mesh.init_groups``, entered
by every rank); a rank outside the mesh waits, and rejoins when a grow
event takes its host back.  The data pipeline re-partitions for the new
DP width (``repartition``), the per-shard local state remaps inside
``restore_latest``, and training continues from the step the event
interrupted.

Scrubbed corruption is agreed too: with the scrubber on, every rank of
the mesh checks its own shards at the top of each superstep and reads
every other rank's verdict from the store, so a flip that only the ranks
holding its shard can see stops every rank at the same step with the same
``CorruptionDetected`` (and the ranks outside the mesh learn of it while
they wait); the caller rolls back (``chaos.run_scenario_elastic``).

Control-plane keys in the store (``el#n/`` prefix, a new ``n`` each call
of ``run_elastic``, ``e`` the mesh epoch): ``start/e`` (the mesh's first
step), ``at/e/s`` (the mesh leader reached boundary ``s``; only read when
rank 0 is outside the mesh), ``v/e/s`` (rank 0's verdict at ``s``: empty
to continue), ``done/e`` (the mesh finished), ``ev/e`` (the event,
JSON), ``sdc/e/s/r`` (rank ``r``'s scrub verdict at ``s``: the corrupt
leaves, comma-separated) and ``sdc/e`` (the agreed corruption, JSON).
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.api import Dependability
from repro_torch.core.coordinator import run_bsp
from repro_torch.core.elastic import (MeshSpec, NoSurvivorsError, best_grid3d,
                                      dp_width, largest_grid, mesh_axis_sizes,
                                      survivor_mesh, survivor_mesh3d)
from repro_torch.core.failures import CorruptionDetected
from repro_torch.sharding.api import mesh_context
from repro_torch.sharding.launch import backoff


@dataclasses.dataclass
class MeshEvent:
    """One elasticity event in a run: the mesh shrank or grew."""
    kind: str                 # "shrink" | "grow"
    hosts: Tuple[int, ...]    # hosts lost (shrink) or rejoined (grow)
    step: int                 # superstep the event interrupted
    dp: int                   # data-parallel width AFTER the event
    tp: int = 1               # model width AFTER the event (3D meshes)
    ep: int = 1               # expert width AFTER the event (3D meshes)

    def as_record(self) -> Dict:
        tail = (f":tp={self.tp}:ep={self.ep}"
                if (self.tp, self.ep) != (1, 1) else "")
        return {"step": self.step, "event":
                f"{self.kind}:{','.join(map(str, self.hosts))}"
                f":dp={self.dp}{tail}"}


@dataclasses.dataclass
class DegradedExperts:
    """Graceful expert degradation: a host failure broke an expert slice
    and the router was renormalized over the survivors instead of aborting
    (``layers.moe.moe_apply``'s ``dead_experts``).  Emitted on the obs
    bus as ``elastic/degraded_experts``."""
    experts: Tuple[int, ...]  # expert ids newly lost (original numbering)
    step: int                 # superstep the loss interrupted
    live: int                 # experts still routable AFTER the loss

    def as_record(self) -> Dict:
        return {"step": self.step, "event":
                f"degraded_experts:{','.join(map(str, self.experts))}"
                f":live={self.live}"}


class _HostLatch:
    """Collects host notifications from the monitor's threads; drained by
    the elastic loop at superstep boundaries.  Latching at callback time
    matters: monitor state is mutable (a transient failure can self-clear
    when a late beat lands), but an event that fired must still be
    handled."""

    def __init__(self, also: Optional[Callable[[int], None]] = None):
        self._lock = threading.Lock()
        self._hosts: set = set()
        self._also = also            # pre-existing user callback, chained

    def __call__(self, host: int) -> None:
        with self._lock:
            self._hosts.add(host)
        if self._also is not None:
            self._also(host)

    def pending(self) -> List[int]:
        with self._lock:
            return sorted(self._hosts)

    def take(self) -> List[int]:
        with self._lock:
            hosts, self._hosts = sorted(self._hosts), set()
            return hosts


class _AgreedStops:
    """The facade as ``run_bsp`` sees it inside ``run_elastic``: every
    stop comes from the agreed verdict (``stop_check``), never from one
    rank's own view of the monitor or signals, and a scrub verdict is the
    mesh's (``verify_state``)."""

    def __init__(self, dep: Dependability, drive: "_Drive", epoch: int,
                 ranks: List[int]):
        self._dep = dep
        self._drive, self._epoch, self._ranks = drive, epoch, ranks

    def __getattr__(self, name):
        return getattr(self._dep, name)

    def interrupted(self) -> bool:
        return False

    def verify_state(self, state, step: int) -> None:
        """Each rank re-checksums its own shards; the corrupt leaves of
        every rank of the mesh are read back from the store, and all
        raise the same ``CorruptionDetected`` when any rank found one."""
        dep = self._dep
        if dep.scrubber is None:
            return
        d, w = self._drive, self._drive.world
        key = f"{d.P}sdc/{self._epoch}/{step}/"
        w.publish(key + str(w.rank), ",".join(dep.scrubber.verify(state)))
        w.wait_keys([key + str(r) for r in self._ranks], d.timeout)
        bad = sorted({n for r in self._ranks
                      for n in w.fetch(key + str(r)).split(",") if n})
        if not bad:
            return
        detail = ",".join(bad)
        w.publish(f"{d.P}sdc/{self._epoch}",
                  json.dumps({"step": step, "detail": detail}))
        dep._emit_sdc(step, "scrub", detail)
        raise CorruptionDetected(step, "scrub", detail)


def _release(device) -> None:
    """Return freed tensors' memory to the card: ranks that share one
    card each keep their own allocator's cache."""
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _accepts_dead(fn) -> bool:
    """True when ``fn`` takes a second positional arg (the dead-experts
    tuple) — lets make_step/shardings_fn opt in without breaking the
    single-argument signature."""
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return False
    positional = [p for p in params if p.kind in
                  (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(positional) >= 2 or any(p.kind == p.VAR_POSITIONAL
                                       for p in params)


def _broken_expert_slices(mesh, lost_devices) -> List[int]:
    """Expert coordinates of ``mesh`` whose rank slice lost a member.  An
    expert slice fails as a unit: one dead rank breaks the whole slice
    (the survivors hold only fragments of its experts)."""
    axes = mesh_axis_sizes(mesh)
    ep = int(axes.get("expert", 1))
    if ep <= 1:
        return []          # experts replicated or no expert axis: no loss
    grid = mesh.devices
    lost = set(lost_devices)
    return [k for k in range(ep)
            if any(int(d) in lost for d in grid[..., k].ravel())]


def run_elastic(dep: Dependability, make_step: Callable, state, data,
                num_steps: int, *, world,
                host_devices: Dict[int, Sequence[int]],
                initial_hosts: Optional[Sequence[int]] = None,
                model_axis: int = 1,
                mesh_spec: Optional[MeshSpec] = None,
                degrade_experts: bool = False,
                like=None,
                shardings_fn: Optional[Callable] = None,
                allow_grow: bool = True,
                max_events: int = 8,
                fault_injector=None,
                on_metrics=None,
                on_event: Optional[Callable[[MeshEvent], None]] = None,
                proactive: Optional[Callable[[int], Optional[str]]] = None,
                on_idle: Optional[Callable[[], None]] = None,
                on_boundary: Optional[Callable[[int], None]] = None,
                control_timeout: float = 600.0) -> Tuple[Any, Dict]:
    """Train to ``num_steps`` surviving host failures and rejoins; every
    rank of ``world`` (``sharding.launch.World``) calls it.

    - ``make_step(mesh)`` -> train_step over the calling rank's shards on
      that mesh (``train.mesh_step.make_mesh_train_step``).  With
      ``degrade_experts`` it may take a second argument, the tuple of lost
      expert ids; ``shardings_fn`` likewise.
    - ``host_devices``: host id -> its ranks; a failed host removes its
      ranks from the mesh.  Rank 0's ``dep`` runs the heartbeat monitor.
    - ``state``: the whole state (each rank keeps its shards on the first
      mesh), or ``state(mesh, shardings)`` returning the rank's shards.
    - ``mesh_spec``: 3D (data, model, expert) meshes, the best legal
      (dp, tp, ep) grid (``survivor_mesh3d``, ep -> dp -> tp); ``None``
      keeps 2D (data, model) meshes with ``model_axis``.
    - ``degrade_experts``: drop the experts whose slice a dead host broke
      and renormalize the router over the survivors (``DegradedExperts``)
      instead of re-gathering them.
    - ``like``: the state's global shapes (``init_state(cfg,
      device="meta")``); ``shardings_fn(mesh)`` -> the state's
      ``NamedSharding`` tree on that mesh.
    - ``data``: the global pipeline (every rank holds the same); with
      ``repartition(dp)`` its shard assignment follows the DP width, and
      its per-shard cursors ride in the checkpoint.
    - ``initial_hosts``: the hosts believed alive at entry.
    - ``on_idle()``: called while the rank waits outside the mesh.
    - ``on_boundary(step)``: rank 0, at each superstep boundary before it
      decides the verdict there (``step`` the state's step).

    Returns ``(state, info)`` with ``info["events"]`` the MeshEvent list
    and ``info["history"]`` this rank's superstep history (a rank outside
    the final mesh returns ``state=None``).  Raises ``NoSurvivorsError``
    on every rank when every host is gone, and ``CorruptionDetected`` on
    every rank when the scrubber found a corrupt shard on any rank of the
    mesh (the state is then the caller's to roll back)."""
    if world.rank == 0 and dep.monitor is None:
        raise ValueError(
            "run_elastic requires the heartbeat monitor on rank 0: "
            "construct its Dependability with heartbeat=True and start() it")
    if dep._local_provider is None and hasattr(data, "state_dict"):
        dep.register_local_state(data)
    if initial_hosts is not None:
        bad = sorted(set(initial_hosts) - set(host_devices))
        if bad:
            raise ValueError(f"initial_hosts {bad} not in host_devices "
                             f"{sorted(host_devices)}")
    run = world._next("el") + "/"        # this call's control-plane keys
    world.publish(f"{run}pid/{world.rank}", str(os.getpid()))
    prev_on_failure = dep.on_host_failure
    prev_on_rejoin = dep.on_host_rejoin
    fail_latch = _HostLatch(also=prev_on_failure)
    rejoin_latch = _HostLatch(also=prev_on_rejoin)
    if world.rank == 0:
        dep.on_host_failure = fail_latch
        if allow_grow:
            dep.on_host_rejoin = rejoin_latch
    prev_world = dep.world
    dep.world = world
    try:
        return _Drive(dep, make_step, data, num_steps, world, fail_latch,
                      rejoin_latch, run, host_devices=host_devices,
                      initial_hosts=initial_hosts, model_axis=model_axis,
                      mesh_spec=mesh_spec, degrade_experts=degrade_experts,
                      like=like, shardings_fn=shardings_fn,
                      allow_grow=allow_grow, max_events=max_events,
                      fault_injector=fault_injector, on_metrics=on_metrics,
                      on_event=on_event, proactive=proactive,
                      on_idle=on_idle, on_boundary=on_boundary,
                      control_timeout=control_timeout).run(state)
    finally:
        # the latches only mean something inside this run
        dep.on_host_failure = prev_on_failure
        dep.on_host_rejoin = prev_on_rejoin
        dep.world = prev_world


class _Drive:
    def __init__(self, dep, make_step, data, num_steps, world, fail_latch,
                 rejoin_latch, run, *, host_devices, initial_hosts,
                 model_axis, mesh_spec, degrade_experts, like, shardings_fn,
                 allow_grow, max_events, fault_injector, on_metrics,
                 on_event, proactive, on_idle, on_boundary,
                 control_timeout):
        self.P = run
        self.dep, self.make_step, self.data = dep, make_step, data
        self.num_steps, self.world = num_steps, world
        self.fail_latch, self.rejoin_latch = fail_latch, rejoin_latch
        self.host_devices = host_devices
        self.model_axis, self.spec = model_axis, mesh_spec
        self.degrade_experts, self.like = degrade_experts, like
        self.shardings_fn, self.allow_grow = shardings_fn, allow_grow
        self.max_events, self.fault_injector = max_events, fault_injector
        self.on_metrics, self.on_event = on_metrics, on_event
        self.proactive, self.on_idle = proactive, on_idle
        self.on_boundary = on_boundary
        self.timeout = control_timeout
        self.active = sorted(host_devices if initial_hosts is None
                             else initial_hosts)
        self.total_experts = (mesh_spec.num_experts
                              if mesh_spec is not None else 0)
        self.dead_experts: set = set()
        self.events: List[MeshEvent] = []
        self.history: List[Dict] = []
        self.last_why: Optional[str] = None     # rank 0's last verdict
        self.paused_at: Optional[int] = None    # the last pause's step

    # ---------------------------------------------------------------
    def grid_of(self, n: int) -> Tuple[int, int, int]:
        if self.spec is not None:
            return best_grid3d(n, self.spec)
        d, _m = largest_grid(n, self.model_axis)
        return (d, 1, 1)

    def call_meshed(self, fn, mesh):
        if fn is None:
            return None
        if self.degrade_experts and _accepts_dead(fn):
            return fn(mesh, tuple(sorted(self.dead_experts)))
        return fn(mesh)

    def build_mesh(self):
        from repro_torch.train.mesh_step import mesh_combos

        ranks = [r for h in self.active for r in self.host_devices[h]]
        w = self.world
        if self.spec is not None:
            mesh = survivor_mesh3d(ranks, self.spec, rank=w.rank,
                                   device=w.device)
        else:
            mesh = survivor_mesh(ranks, model_axis=self.model_axis,
                                 rank=w.rank, device=w.device)
        return mesh.init_groups(mesh_combos(mesh))

    # ---------------------------------------------------------------
    def decide(self, step: int) -> Optional[str]:
        """Rank 0: the reason to pause at boundary ``step``, or None."""
        if self.on_boundary is not None:
            self.on_boundary(step)
        dep = self.dep
        failed = ((set(dep.monitor.failed_hosts())
                   | set(self.fail_latch.pending())) & set(self.active))
        if failed:
            return "failure:" + ",".join(map(str, sorted(failed)))
        if dep.signals is not None and dep.signals.triggered():
            return "signal"
        if self.allow_grow:
            back = [h for h in self.rejoin_latch.pending()
                    if h in self.host_devices and h not in self.active]
            if back:
                return "rejoin:" + ",".join(map(str, back))
        return None

    def stop_check(self, epoch: int, start: int, leader: int):
        """The verdict function every mesh rank polls at its boundaries
        (boundaries ``start``, ``start + 1``, ...)."""
        w = self.world
        box = {"step": start}

        def check() -> Optional[str]:
            s = box["step"]
            box["step"] = s + 1
            key = f"{self.P}v/{epoch}/{s}"
            if w.rank == 0:
                why = self.decide(s)
                self.last_why = why
                w.publish(key, why or "")
                return why
            if w.rank == leader:
                w.publish(f"{self.P}at/{epoch}/{s}", "1")
            return w.fetch(key, self.timeout) or None
        return check

    def serve_verdicts(self, epoch: int) -> int:
        """Rank 0 outside the mesh: answer the leader's boundaries until
        the mesh pauses or finishes; returns the step it stopped at."""
        w = self.world
        w.wait_keys([f"{self.P}start/{epoch}"], self.timeout)
        s = int(w.fetch(f"{self.P}start/{epoch}"))
        deadline = time.monotonic() + self.timeout
        pause = 0.001
        while True:
            if w.has(f"{self.P}at/{epoch}/{s}"):
                why = self.decide(s)
                self.last_why = why
                w.publish(f"{self.P}v/{epoch}/{s}", why or "")
                if why:
                    return s
                s += 1
                deadline = time.monotonic() + self.timeout
                pause = 0.001
            elif w.has(f"{self.P}done/{epoch}"):
                return int(w.fetch(f"{self.P}done/{epoch}"))
            elif time.monotonic() > deadline:
                raise TimeoutError(f"rank 0: no boundary {s} of mesh "
                                   f"epoch {epoch} within {self.timeout} s")
            self.idle(epoch)
            pause = backoff(pause)

    def idle(self, epoch: int) -> None:
        """A poll outside the mesh (or at the epoch's barrier): the mesh's
        agreed corruption ends the wait; then ``on_idle``."""
        key = f"{self.P}sdc/{epoch}"
        if self.world.has(key):
            got = json.loads(self.world.fetch(key))
            raise CorruptionDetected(got["step"], "scrub", got["detail"])
        if self.on_idle is not None:
            self.on_idle()

    def wait_event(self, epoch: int) -> None:
        w = self.world
        deadline = time.monotonic() + self.timeout
        pause = 0.001
        while not w.has(f"{self.P}ev/{epoch}"):
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank {w.rank}: no event for mesh "
                                   f"epoch {epoch} within {self.timeout} s")
            self.idle(epoch)
            pause = backoff(pause)

    def make_event(self, status: str, cur: int) -> Dict:
        """Rank 0, after the mesh paused or finished."""
        monitor = self.dep.monitor
        failed = sorted((set(monitor.failed_hosts())
                         | set(self.fail_latch.take())) & set(self.active))
        rejoined = [h for h in self.rejoin_latch.take()
                    if h in self.host_devices and h not in self.active]
        for h in failed:
            monitor.acknowledge(h)   # handled: stop flagging it
        return {"status": status, "cur": cur, "failed": failed,
                "rejoined": rejoined, "signal": self.last_why == "signal"}

    def emit(self, *args, **kw):
        if self.dep.obs is not None:
            self.dep.obs.emit(*args, **kw)

    # ---------------------------------------------------------------
    def run(self, state):
        dep, w = self.dep, self.world
        first = True
        epoch = 0
        while True:
            mesh = self.build_mesh()
            axes = mesh_axis_sizes(mesh)
            dp = dp_width(mesh)
            tp, ep = int(axes.get("model", 1)), int(axes.get("expert", 1))
            # the grid the next save is sharded on, for a restart or
            # reshard_state to rebuild expert placement from the manifest
            dep.mesh_meta = {"dp": dp, "tp": tp, "ep": ep,
                             "moe_ep": ep if self.spec is not None else False,
                             "dead_experts": sorted(self.dead_experts)}
            if hasattr(self.data, "repartition"):
                self.data.repartition(dp)
            ranks = mesh.ranks()
            leader = ranks[0]
            status, cur = None, None
            if mesh.member:
                dep.manager.set_hosts(
                    ranks.index(w.rank), len(ranks),
                    owner_pid=int(w.fetch(f"{self.P}pid/{leader}",
                                          self.timeout)))
                dep.set_ckpt_tag(f"{self.P}{epoch}")
                shardings = self.call_meshed(self.shardings_fn, mesh)
                dep.register_global_state(self.like, shardings)
                train_step = self.call_meshed(self.make_step, mesh)
                with mesh_context(mesh):
                    if first:
                        if callable(state):
                            state = state(mesh, shardings)
                        elif shardings is not None:
                            from repro_torch.train.mesh_step import shard_tree
                            state = shard_tree(state, shardings)
                    else:
                        # the old mesh's shards go before the new ones come
                        state = None
                        _release(w.device)
                        # the pause's final save, by its step: a rank that
                        # sat outside the mesh has not seen the saves
                        # since, and its scrub-verified steps would prefer
                        # an older one
                        state, got = dep.restore_latest(
                            like=self.like, shardings=shardings,
                            step=self.paused_at)
                        if dep.scrubber is not None:
                            # the pause's state in this mesh's shards: the
                            # scrub window's leaves, checksummed anew
                            dep.scrubber.rebase(state)
                        tail = (f":tp={tp}:ep={ep}" if self.spec is not None
                                else "")
                        self.history.append({"step": got,
                                             "event": f"resume:dp={dp}{tail}"})
                        if dep.obs is not None:
                            dep.obs.emit("elastic", "resume", step=got,
                                         dp=dp, tp=tp, ep=ep)
                            dep.obs.registry.gauge(
                                "elastic.dp_width").set(dp)
                            if self.spec is not None:
                                dep.obs.registry.gauge(
                                    "elastic.tp_width").set(tp)
                                dep.obs.registry.gauge(
                                    "elastic.ep_width").set(ep)
                    start = int(state["step"])
                    if w.rank == leader:
                        w.publish(f"{self.P}start/{epoch}", str(start))
                    state, bsp_status, hist = run_bsp(
                        _AgreedStops(dep, self, epoch, ranks), train_step,
                        state, self.data,
                        self.num_steps, fault_injector=self.fault_injector,
                        on_metrics=self.on_metrics,
                        stop_check=self.stop_check(epoch, start, leader),
                        proactive=self.proactive)
                self.history.extend(hist)
                cur = int(state["step"])
                status = "done" if bsp_status == "done" else "paused"
                if status == "done" and w.rank == leader:
                    w.publish(f"{self.P}done/{epoch}", str(cur))
            else:
                if state is not None and not callable(state):
                    state = None
                    _release(w.device)
                if w.rank == 0:
                    cur = self.serve_verdicts(epoch)
                    status = ("done" if w.has(f"{self.P}done/{epoch}")
                              and cur >= self.num_steps else "paused")
            first = False
            # every rank's final save has landed and been committed
            w.barrier(f"{self.P}epoch{epoch}", timeout=self.timeout,
                      poll=lambda: self.idle(epoch))
            if w.rank == 0:
                ev = self.make_event(status, cur)
                w.publish(f"{self.P}ev/{epoch}", json.dumps(ev))
            else:
                self.wait_event(epoch)
                ev = json.loads(w.fetch(f"{self.P}ev/{epoch}"))
            epoch += 1
            out = self.apply(ev, mesh, dp)
            if out is not None:
                return (state if mesh.member else None), out

    def apply(self, ev: Dict, mesh, dp: int) -> Optional[Dict]:
        """The same bookkeeping on every rank; returns the final info when
        the run ends."""
        dep = self.dep
        cur, failed, rejoined = ev["cur"], ev["failed"], ev["rejoined"]
        self.paused_at = cur
        if ev["status"] == "done":
            return {"status": "done", "events": self.events,
                    "history": self.history, "dp": dp}
        if failed:
            if self.degrade_experts and self.spec is not None:
                lost = [r for h in failed if h in self.host_devices
                        for r in self.host_devices[h]]
                broken = _broken_expert_slices(mesh, lost)
                if broken:
                    ep = int(mesh_axis_sizes(mesh).get("expert", 1))
                    live_ids = [e for e in range(self.total_experts)
                                if e not in self.dead_experts]
                    per = len(live_ids) // max(ep, 1)
                    newly = sorted(e for k in broken
                                   for e in live_ids[k * per:(k + 1) * per])
                    still = len(live_ids) - len(newly)
                    if still <= 0:
                        raise NoSurvivorsError(
                            f"every expert slice broke at step {cur}: "
                            f"experts {newly} all lost")
                    self.dead_experts.update(newly)
                    self.spec = self.spec.with_experts(still)
                    degraded = DegradedExperts(tuple(newly), cur, still)
                    self.history.append(degraded.as_record())
                    if dep.obs is not None:
                        dep.obs.emit("elastic", "degraded_experts",
                                     experts=list(degraded.experts),
                                     step=cur, live=still)
                        dep.obs.registry.gauge(
                            "elastic.live_experts").set(still)
            # a concurrent rejoin rides the same mesh rebuild
            active = sorted(set(self.active) | set(rejoined))
            self.active = [h for h in active if h not in failed]
            survivors = [r for h in self.active
                         for r in self.host_devices[h]]
            if not survivors:
                raise NoSurvivorsError(
                    f"all hosts failed at step {cur}: {sorted(failed)}")
            event = MeshEvent("shrink", tuple(failed), cur,
                              *self.grid_of(len(survivors)))
        elif rejoined:
            self.active = sorted(set(self.active) | set(rejoined))
            grown = [r for h in self.active for r in self.host_devices[h]]
            event = MeshEvent("grow", tuple(rejoined), cur,
                              *self.grid_of(len(grown)))
        elif ev["status"] == "paused" and ev.get("signal"):
            # a termination signal, not an elasticity event: the final
            # checkpoint is already written
            return {"status": "interrupted", "events": self.events,
                    "history": self.history, "dp": dp}
        else:
            return None          # a stale rejoin: the same mesh again
        self.events.append(event)
        if dep.obs is not None:
            dep.obs.emit("elastic", event.kind, hosts=list(event.hosts),
                         step=event.step, dp=event.dp, tp=event.tp,
                         ep=event.ep)
            dep.obs.registry.counter(f"elastic.{event.kind}s").inc()
        if len(self.events) > self.max_events:
            raise RuntimeError(
                f"mesh changed {len(self.events)} times (> max_events="
                f"{self.max_events}); giving up: {self.events}")
        self.history.append(event.as_record())
        if self.on_event is not None:
            self.on_event(event)
        return None
