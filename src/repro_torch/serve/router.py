"""Replica router: dispatch to healthy replicas, drain the dead ones.

Failure detection reuses the training stack wholesale: every replica runs
a ``HeartbeatEmitter`` under its replica id against one
``HeartbeatMonitor`` (``watch``/``unwatch`` register ids added after
start — warm standbys).  Detection arrives on monitor threads, so the
router latches it (same pattern as ``core.elastic_loop._HostLatch``) and
the engine drains the latch at step boundaries.  A replica can also die
synchronously — an injected ``SimulatedFailure(kind="replica-kill")`` or
a ``DecodeSentinel`` trip — in which case the router fails it immediately
and pauses its emitter so the monitor's view agrees.

Failing a replica drains its in-flight requests (``PagedKVCache.release_all``
in row order) back to the scheduler queue; greedy decode makes the
re-execution on a survivor token-identical.  If warm standbys were
registered, one is activated per failure: params materialized from its
source (any zero-argument callable; a source over ``CheckpointManager``
waits for the checkpoint slice), a new replica id registered with the
monitor, serve steps shared, so capacity recovers without a process
relaunch.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.heartbeat import HeartbeatMonitor
from repro_torch.sdc import DecodeSentinel
from repro_torch.serve.replica import Replica, ServeFns


class NoHealthyReplicasError(RuntimeError):
    """Every replica is dead and no standby remains — the serving
    counterpart of ``core.elastic.NoSurvivorsError``."""


class ReplicaRouter:
    def __init__(self, fns: ServeFns,
                 monitor: Optional[HeartbeatMonitor] = None,
                 heartbeat_period: float = 0.05,
                 sentinel_factory: Optional[Callable[[], DecodeSentinel]]
                 = None,
                 hosts_per_replica: int = 1,
                 registry=None):
        self.fns = fns
        self.monitor = monitor
        self.heartbeat_period = heartbeat_period
        self.sentinel_factory = sentinel_factory
        self.registry = registry             # metrics for paged pools
        self.hosts_per_replica = max(int(hosts_per_replica), 1)
        self.replicas: Dict[int, Replica] = {}
        self._standby_sources: List[Callable[[], object]] = []
        self._next_id = 0
        self._next_host = 0              # next unused heartbeat identity
        self._host_to_rid: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._detected: set = set()      # monitor-thread detections, latched
        self.events: List[Tuple[str, int, str]] = []   # (kind, id, detail)
        if monitor is not None:
            # chain, don't clobber: the embedding application may watch too
            prev = monitor.on_failure
            monitor.on_failure = lambda h: (self._latch(h),
                                            prev(h) if prev else None)

    def _latch(self, replica_id: int) -> None:
        with self._lock:
            self._detected.add(replica_id)

    def take_detected(self) -> List[int]:
        """Replica ids the monitor declared failed since the last drain,
        plus any currently-failed ids (covers a detection that landed
        between ``start`` and the first latch wiring).

        Detections arrive as HOST ids; a multi-host replica maps every one
        of its hosts to the same replica id, so losing several hosts of a
        tp group — or one — surfaces the replica exactly once."""
        with self._lock:
            got, self._detected = set(self._detected), set()
        if self.monitor is not None:
            got |= set(self.monitor.failed_hosts())
        rids = {self._host_to_rid[h] for h in got if h in self._host_to_rid}
        return sorted(r for r in rids
                      if r in self.replicas and self.replicas[r].healthy)

    # ------------------------------------------------------------------
    # pool membership
    # ------------------------------------------------------------------
    def add_replica(self, params,
                    hosts_per_replica: Optional[int] = None) -> Replica:
        """``hosts_per_replica > 1``: the replica's params are sharded over
        a multi-host tp group — it gets that many heartbeat identities and
        fails over AS A UNIT (one drain) when any of them dies.  Default:
        the router-wide setting (so activated standbys match too)."""
        k = (self.hosts_per_replica if hosts_per_replica is None
             else max(int(hosts_per_replica), 1))
        rid = self._next_id
        self._next_id += 1
        hosts = tuple(range(self._next_host, self._next_host + k))
        self._next_host += k
        sentinel = (self.sentinel_factory() if self.sentinel_factory
                    else None)
        rep = Replica(rid, params, self.fns, sentinel=sentinel, hosts=hosts,
                      registry=self.registry)
        self.replicas[rid] = rep
        for h in hosts:
            self._host_to_rid[h] = rid
        if self.monitor is not None:
            for h in hosts:
                self.monitor.watch(h)
            rep.attach_emitter(self.monitor.addr, self.heartbeat_period)
        return rep

    def add_standby(self, source: Callable[[], object]) -> None:
        """Register a warm standby: ``source()`` materializes its params
        at activation time."""
        self._standby_sources.append(source)

    @property
    def standby_count(self) -> int:
        return len(self._standby_sources)

    def healthy(self) -> List[Replica]:
        return [r for r in self.replicas.values() if r.healthy]

    # ------------------------------------------------------------------
    # failure handling
    # ------------------------------------------------------------------
    def fail_replica(self, rep: Replica, reason: str) -> List[int]:
        """Take a replica out of service; returns the drained rids (slot
        order).  Idempotent: a replica already failed drains nothing.

        A multi-host replica fails AS A UNIT: every host's emitter pauses
        and every host is acknowledged, but the pool drains exactly once —
        one failover incident, not one per host."""
        if not rep.healthy:
            return []
        rep.healthy = False
        rep.fail_reason = reason
        for em in rep.emitters:
            em.pause()                   # monitor view must agree: no beats
        if self.monitor is not None:
            for h in rep.hosts:
                self.monitor.acknowledge(h)
        drained = rep.pool.release_all()
        self.events.append(("replica_failed", rep.id,
                            f"{reason};drained={len(drained)}"))
        return drained

    def drain_replica(self, rep: Replica, reason: str) -> List[int]:
        """Proactively take a replica out of service BEFORE it fails
        (the telemetry plane's pre-drain, docs/observability.md):
        mechanically identical to ``fail_replica`` — emitters pause,
        hosts are acknowledged, the pool drains once — but recorded as
        ``replica_predrained``, and the acknowledged hosts never produce
        a ``heartbeat/failure`` event, so the Timeline sees a planned
        drain, not an incident."""
        if not rep.healthy:
            return []
        rep.healthy = False
        rep.fail_reason = f"predrain:{reason}"
        for em in rep.emitters:
            em.pause()
        if self.monitor is not None:
            for h in rep.hosts:
                self.monitor.acknowledge(h)
        drained = rep.pool.release_all()
        self.events.append(("replica_predrained", rep.id,
                            f"{reason};drained={len(drained)}"))
        return drained

    def activate_standby(self) -> Optional[Replica]:
        """Bring one warm standby into the pool (None when none remain)."""
        if not self._standby_sources:
            return None
        source = self._standby_sources.pop(0)
        rep = self.add_replica(source())
        self.events.append(("standby_activated", rep.id, ""))
        return rep

    def shutdown(self) -> None:
        for rep in self.replicas.values():
            rep.shutdown()
