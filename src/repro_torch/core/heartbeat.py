"""UDP heartbeat monitoring (paper-faithful: DeLIA uses UDP for efficient
liveness signaling).

- ``HeartbeatEmitter``: thread sending ``{host_id, seq, t}`` datagrams every
  ``period`` seconds to the monitor address.
- ``HeartbeatMonitor``: thread receiving beats; declares a host FAILED when
  no beat arrives within ``timeout = k * period`` (fail-stop detection) and
  invokes ``on_failure(host_id)`` exactly once per failure.

Paper limitation honored: a heartbeat only proves the emitter thread is
alive ("garante somente o funcionamento da componente para envio dos
batimentos") — the coordinator therefore also feeds ``progress_beat`` from
the BSP loop so a wedged-but-alive process is distinguishable (beyond-paper
strengthening, recorded in DESIGN.md).
"""
from __future__ import annotations

import json
import socket
import threading
import time
from typing import Callable, Dict, Optional


class HeartbeatEmitter:
    def __init__(self, host_id: int, monitor_addr, period: float = 0.1):
        self.host_id = host_id
        self.monitor_addr = monitor_addr
        self.period = period
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._stop = threading.Event()
        self._seq = 0
        # incarnation: stamped once per emitter lifetime, from THIS host's
        # clock only — the monitor orders (inc, seq) pairs per host, so a
        # restarted process (new inc) or resumed emitter (same inc, larger
        # seq) is distinguishable from a stale in-flight datagram without
        # ever comparing clocks across hosts
        self._inc = time.time()
        self._thread: Optional[threading.Thread] = None
        self._paused = threading.Event()
        # chaos hook (a partition in a chaos driver): the "network" between
        # emitter and monitor.  When set, each datagram's payload is offered to the
        # filter and DROPPED unless it returns True — a partition drops
        # beats while the emitter keeps running (asymmetric liveness: this
        # host still believes it is connected), unlike pause(), which
        # models the process itself dying.  seq keeps advancing across the
        # partition, so healing is indistinguishable from ordinary delivery
        # under the monitor's (inc, seq) ordering.
        self.send_filter: Optional[Callable[[dict], bool]] = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def pause(self):
        """Simulates fail-stop (the paper's fault model): beats just stop."""
        self._paused.set()

    def resume(self):
        self._paused.clear()

    def _run(self):
        while not self._stop.is_set():
            if not self._paused.is_set():
                payload = {"host": self.host_id, "seq": self._seq,
                           "inc": self._inc, "t": time.time()}
                gate = self.send_filter
                if gate is None or gate(payload):
                    try:
                        self._sock.sendto(json.dumps(payload).encode(),
                                          self.monitor_addr)
                    except OSError:
                        pass
                self._seq += 1
            time.sleep(self.period)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
        self._sock.close()


class HeartbeatMonitor:
    def __init__(self, num_hosts: int, period: float = 0.1,
                 timeout_factor: float = 5.0,
                 on_failure: Optional[Callable[[int], None]] = None,
                 on_rejoin: Optional[Callable[[int], None]] = None,
                 startup_grace: Optional[float] = None,
                 bind=("127.0.0.1", 0), obs=None):
        self.num_hosts = num_hosts
        # telemetry (repro_torch.obs.Observability): failure/rejoin events plus
        # the per-host last-beat -> declared-failure latency histogram
        self.obs = obs
        self.period = period
        self.timeout = timeout_factor * period
        # extra allowance before a never-seen host counts as failed: real
        # launches skew (host k may reach start() well after host 0), so
        # the first beat gets more slack than the steady-state timeout
        self.startup_grace = (2.0 * self.timeout if startup_grace is None
                              else startup_grace)
        self.on_failure = on_failure
        self.on_rejoin = on_rejoin
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(bind)
        self._sock.settimeout(period / 2)
        self.addr = self._sock.getsockname()
        self.last_seen: Dict[int, float] = {}
        self.failed: Dict[int, float] = {}
        # acknowledged failures, out of the mesh
        self.excluded: set = set()
        # newest (inc, seq) accepted per host: a datagram at or below it is
        # a stale in-flight beat, not a rejoin
        self._last_beat: Dict[int, tuple] = {}
        # host -> seconds from last accepted beat to the failure
        # declaration, for the most recent failure of that host.  This is
        # the measured detection term D the Young/Daly model otherwise
        # only estimates (bench_heartbeat recomputed it externally before).
        self.detection_latency: Dict[int, float] = {}
        self._stop = threading.Event()
        self._threads = []
        self._lock = threading.Lock()

    def start(self):
        # Seed last_seen for every expected host so one that is silent from
        # birth still trips the timeout (it has no beat to populate the dict
        # with otherwise — it would never be declared failed).  Seeded into
        # the future by startup_grace: launch skew must not read as death.
        seed = time.time() + self.startup_grace
        with self._lock:
            for h in range(self.num_hosts):
                self.last_seen.setdefault(h, seed)
        t1 = threading.Thread(target=self._recv_loop, daemon=True)
        t2 = threading.Thread(target=self._check_loop, daemon=True)
        self._threads = [t1, t2]
        t1.start()
        t2.start()
        return self

    def watch(self, host: int) -> None:
        """Begin monitoring an identity added after start() — e.g. a warm
        standby serving replica activated into the pool (replica-scoped
        registration, docs/serving.md).  Seeded with the same startup
        grace as the initial hosts: activation skew is not death."""
        with self._lock:
            self.excluded.discard(host)
            self.failed.pop(host, None)
            self.last_seen.setdefault(host,
                                      time.time() + self.startup_grace)

    def unwatch(self, host: int) -> None:
        """Stop monitoring an identity that was decommissioned on purpose
        (replica scaled away) — unlike ``acknowledge`` it forgets the
        (inc, seq) history too, so a fresh replica may reuse the id."""
        with self._lock:
            self.failed.pop(host, None)
            self.last_seen.pop(host, None)
            self.excluded.discard(host)
            self._last_beat.pop(host, None)

    def acknowledge(self, host: int) -> None:
        """The recovery layer handled this failure: stop counting the host
        as failed and stop monitoring it until it beats again (rejoin)."""
        with self._lock:
            self.failed.pop(host, None)
            self.last_seen.pop(host, None)
            self.excluded.add(host)

    def _recv_loop(self):
        while not self._stop.is_set():
            try:
                data, _ = self._sock.recvfrom(4096)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                msg = json.loads(data.decode())
            except (ValueError, UnicodeDecodeError):
                continue
            rejoined = None
            with self._lock:
                h = int(msg["host"])
                beat = (float(msg.get("inc", 0.0)), int(msg.get("seq", 0)))
                if h in self.excluded:
                    # only a beat NEWER than everything accepted before the
                    # failure is a rejoin (same emitter resumed: same inc,
                    # larger seq; restarted process: larger inc).  A stale
                    # in-flight datagram compares <= and growing the mesh
                    # back onto a dead host would just re-fail it.  Both
                    # sides of the comparison come from the same host's
                    # clock, so cross-host skew cannot break it.
                    if beat <= self._last_beat.get(h, (0.0, -1)):
                        continue
                    self.excluded.discard(h)
                    rejoined = h
                if beat > self._last_beat.get(h, (0.0, -1)):
                    self._last_beat[h] = beat
                self.last_seen[h] = time.time()
                # a failed host beating again = recovered (failover/rejoin)
                self.failed.pop(h, None)
            if rejoined is not None:
                if self.obs is not None:
                    self.obs.emit("heartbeat", "rejoin", host=rejoined)
                    self.obs.registry.counter("heartbeat.rejoins").inc()
                if self.on_rejoin:
                    self.on_rejoin(rejoined)

    def _check_loop(self):
        while not self._stop.is_set():
            now = time.time()
            newly_failed = []
            with self._lock:
                for h, seen in list(self.last_seen.items()):
                    if h in self.failed:
                        continue
                    if now - seen > self.timeout:
                        self.failed[h] = now
                        # last-beat -> declaration gap; clamped because a
                        # never-seen host's last_seen is seeded into the
                        # future by startup_grace
                        self.detection_latency[h] = max(0.0, now - seen)
                        newly_failed.append(h)
            for h in newly_failed:
                self._observe_failure(h)
            # callbacks run OUTSIDE the lock: handlers may call back into
            # the monitor (acknowledge, failed_hosts, ...) without deadlock
            if self.on_failure:
                for h in newly_failed:
                    self.on_failure(h)
            time.sleep(self.period / 2)

    def _observe_failure(self, host: int) -> None:
        if self.obs is None:
            return
        latency = self.detection_latency.get(host, 0.0)
        self.obs.emit("heartbeat", "failure", host=host,
                      detection_latency_s=latency)
        self.obs.registry.histogram("heartbeat.detection_latency_ms",
                                    host=host).observe(latency * 1e3)
        self.obs.registry.counter("heartbeat.failures").inc()

    def alive_hosts(self):
        with self._lock:
            return sorted(h for h in self.last_seen
                          if h not in self.failed and h not in self.excluded)

    def failed_hosts(self):
        with self._lock:
            return sorted(self.failed)

    def any_failure(self) -> bool:
        with self._lock:
            return bool(self.failed)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._sock.close()
