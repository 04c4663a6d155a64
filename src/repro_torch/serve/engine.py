"""The dependable serving engine: continuous batching + replicated failover.

One ``ServeEngine`` owns a request ``Scheduler``, a ``ReplicaRouter`` over
N model replicas (each with its own cache pool: block-paged KV, or the
slot pool of contiguous rows), and —
when ``fault_tolerant`` — a ``HeartbeatMonitor`` the replicas beat into.
Each engine step, per healthy replica:

1. **admit**: pop queued requests while the pool can take them (up to
   ``max_prefill_per_step``): paged, while it can cover their prompt
   pages plus a worst-case growth reservation, each prefilled B=1 and its
   pages scattered into the pool — or, on an exact full-prompt prefix
   hit, opened with the stored first token and no prefill; slot pool,
   while a slot is free, each prefilled B=1 and its row copied into the
   slot;
2. **decode**: one batched step over every row of the pool; every active
   row's request gains one greedy token;
3. **guard**: the ``DecodeSentinel`` watches the step's logit stats —
   non-finite logits or an entropy spike flags the REPLICA as corrupt.

Failures — heartbeat-detected (drained at the next step boundary),
injected (``FaultInjector.schedule_replica_kill``), or sentinel-flagged —
all take the same path: the router excludes the replica, its in-flight
requests drain back to the queue with partial output discarded (slots,
page tables and prefix refs released leak-free), and survivors re-execute
them.  Greedy decode is a pure function of the prompt, so the retried
streams are token-identical to an uninterrupted run and the engine drops
zero requests.  Warm standbys (``add_standby``) are activated one per
failure to restore capacity.

The telemetry plane adds the *proactive* path (docs/observability.md):
with ``risk_source`` set (host -> risk in [0, 1], e.g. a local
``AnomalyEngine.risk_scores`` or ``Collector.risk_scores``), the engine
pre-drains a replica whose host risk crosses ``pre_drain_threshold`` —
same drain + requeue + token-identical retry machinery, but triggered
BEFORE the failure, so the predicted failure costs a planned drain
instead of a detection-latency-bound failover.  A replica is only
pre-drained while another healthy replica or a warm standby can absorb
its load.  With ``risk_source`` set the engine also emits per-replica
step timings (``telemetry/replica_step``) so the drift detector can
attribute slowdowns to hosts.

``paged=None`` pages wherever the stack can (attention-only, plain
RoPE); a Mamba or RG-LRU stack takes the slot pool.  The engine serves
token prompts: an encoder-only or embedding-input config is refused, as
in the reference.  ``paged=False`` forces the slot pool on an
attention stack too (the CLI's ``--legacy-pool``): at equal decode
shapes its greedy streams equal the paged pool's bit for bit.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.failures import CorruptionDetected, SimulatedFailure
from repro_torch.core.heartbeat import HeartbeatMonitor
from repro_torch.device import resolve_device
from repro_torch.models.base import FULL, LOCAL
from repro_torch.obs import Observability
from repro_torch.sdc import DecodeSentinel
from repro_torch.serve.page_table import DEFAULT_PAGE_SIZE, PageExhausted
from repro_torch.serve.replica import Replica, ServeFns
from repro_torch.serve.router import NoHealthyReplicasError, ReplicaRouter
from repro_torch.serve.scheduler import DECODE, Scheduler

def _supports_paging(cfg) -> bool:
    """Paged KV needs an attention-only decode stack (SSM/REC state has
    no sequence axis to page) and plain RoPE positions."""
    return (all(k in (FULL, LOCAL) for k in cfg.layer_kinds())
            and not cfg.mrope_sections)


def pctl(xs, q: float) -> float:
    """Nearest-rank percentile over a non-empty sample."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


class ServeEngine:
    def __init__(self, cfg, params, *, device=None,
                 num_replicas: int = 1,
                 slots_per_replica: int = 4, max_len: int = 256,
                 hosts_per_replica: int = 1,
                 fault_tolerant: bool = False,
                 heartbeat_period: float = 0.05,
                 heartbeat_timeout_factor: float = 5.0,
                 sentinel: bool = True,
                 sentinel_spike_factor: float = 4.0,
                 max_pending: int = 256,
                 max_prefill_per_step: int = 2,
                 max_retries: int = 3,
                 fault_injector=None,
                 obs: Optional[Observability] = None,
                 risk_source: Optional[Callable[[], Dict[int, float]]]
                 = None,
                 pre_drain_threshold: float = 0.8,
                 paged: Optional[bool] = None,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 num_pages: Optional[int] = None,
                 max_active: Optional[int] = None,
                 prefix_cache: bool = True):
        self.device = resolve_device(device)
        if not cfg.has_decode:
            raise ValueError(f"{cfg.name} is encoder-only; cannot serve "
                             "autoregressive decode")
        if cfg.embedding_inputs:
            raise ValueError(f"{cfg.name} takes embedding inputs; the "
                             "engine serves token prompts")
        # the paged pool wherever the stack supports it; the slot pool
        # otherwise (the SSM fallback) or when asked for
        if paged is None:
            paged = _supports_paging(cfg)
        elif paged and not _supports_paging(cfg):
            raise ValueError(f"{cfg.name} cannot page its KV cache "
                             "(non-attention decode state or M-RoPE)")
        self.cfg = cfg
        self.paged = paged
        self.obs = obs if obs is not None else Observability()
        self.fns = ServeFns(cfg, slots_per_replica, max_len, self.device,
                            paged=paged,
                            page_size=page_size, num_pages=num_pages,
                            max_active=max_active,
                            prefix_cache=prefix_cache)
        self.scheduler = Scheduler(max_pending=max_pending,
                                   max_retries=max_retries)
        self.injector = fault_injector
        self.max_prefill_per_step = max_prefill_per_step
        hosts_per_replica = max(int(hosts_per_replica), 1)
        self.monitor: Optional[HeartbeatMonitor] = None
        if fault_tolerant:
            self.monitor = HeartbeatMonitor(
                num_replicas * hosts_per_replica, period=heartbeat_period,
                timeout_factor=heartbeat_timeout_factor,
                obs=self.obs).start()
        sentinel_factory = None
        if sentinel:
            # hard ceiling just under uniform: a replica corrupt from the
            # first step (bad standby restore) trips even during warmup
            ceiling = 0.98 * math.log(cfg.padded_vocab)
            sentinel_factory = lambda: DecodeSentinel(  # noqa: E731
                spike_factor=sentinel_spike_factor,
                abs_max_entropy=ceiling)
        self.router = ReplicaRouter(self.fns, self.monitor,
                                    heartbeat_period=heartbeat_period,
                                    sentinel_factory=sentinel_factory,
                                    hosts_per_replica=hosts_per_replica,
                                    registry=self.obs.registry)
        # replicas share ONE set of parameter tensors
        for _ in range(num_replicas):
            self.router.add_replica(params)
        self.risk_source = risk_source
        self.pre_drain_threshold = pre_drain_threshold
        self.engine_step = 0

    @property
    def events(self) -> List[Dict[str, Any]]:
        """The engine's event history from the obs bus ("serve"
        subsystem): ``{"t", "step", "event", ...}`` dicts."""
        return [{"t": e.t_mono, "step": e.data.get("step"),
                 "event": e.kind,
                 **{k: v for k, v in e.data.items() if k != "step"}}
                for e in self.obs.events(subsystem="serve")]

    # ------------------------------------------------------------------
    # client surface
    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int) -> int:
        """Admit one request (raises ``scheduler.QueueFull`` past
        ``max_pending``); returns the request id."""
        need = len(prompt) + max_new_tokens - 1
        if need > self.fns.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) needs {need} cache positions > "
                f"max_len {self.fns.max_len}")
        req = self.scheduler.submit(prompt, max_new_tokens,
                                    t_submit=time.perf_counter())
        return req.rid

    def add_standby(self, source) -> None:
        """Register a warm standby: ``source()`` returns its params."""
        self.router.add_standby(source)

    def results(self) -> Dict[int, List[int]]:
        return self.scheduler.results()

    def reap(self, rid: int) -> List[int]:
        return list(self.scheduler.reap(rid).tokens)

    def drain_finished(self) -> Dict[int, List[int]]:
        return {r.rid: list(r.tokens)
                for r in self.scheduler.reap_finished()}

    def page_conservation(self) -> Dict[str, int]:
        """Aggregate page-accounting sample over every replica's pool
        (pages_free + pages_held == pages_total, refcounts consistent).
        Dead replicas count too: their drained pools must sit fully
        free."""
        agg = {"pages_total": 0, "pages_free": 0, "pages_held": 0,
               "pages_reserved": 0, "refs_ok": 1}
        for rep in self.router.replicas.values():
            s = rep.pool.conservation()
            for k in ("pages_total", "pages_free", "pages_held",
                      "pages_reserved"):
                agg[k] += s[k]
            agg["refs_ok"] &= s["refs_ok"]
        return agg

    def request_latencies(self) -> List[Tuple[int, float, float]]:
        """[(rid, time-to-first-token, total latency), ...] for DONE
        requests; a retried request's TTFT runs to its retry's first
        token."""
        out = []
        for r in self.scheduler.requests.values():
            if r.t_done is not None and r.t_first_token is not None:
                out.append((r.rid, r.t_first_token - r.t_submit,
                            r.t_done - r.t_submit))
        return out

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def step(self) -> None:
        """One engine iteration over every healthy replica."""
        self._drain_detected()
        if self.risk_source is not None:
            self._pre_drain_risky()
        healthy = sorted(self.router.healthy(), key=lambda r: r.id)
        if not healthy and not self.scheduler.all_done():
            rep = self.router.activate_standby()
            if rep is None:
                raise NoHealthyReplicasError(
                    "every replica failed and no warm standby remains; "
                    f"{len(self.scheduler.in_flight())} requests in "
                    f"flight, {self.scheduler.pending()} queued")
            self._record("standby_activated", replica=rep.id)
            healthy = [rep]
        for rep in healthy:
            try:
                self._step_replica(rep)
            except SimulatedFailure as e:
                self._fail(rep, f"injected:{e.kind}")
            except CorruptionDetected as e:
                self._fail(rep, f"sentinel:{e.detail}")
        self.engine_step += 1
        reg = self.obs.registry
        reg.gauge("serve.queue_depth").set(self.scheduler.pending())
        reg.gauge("serve.in_flight").set(len(self.scheduler.in_flight()))
        reg.gauge("serve.healthy_replicas").set(len(healthy))
        if self.paged:
            reg.gauge("serve.pages_free").set(
                sum(r.pool.free_pages for r in self.router.healthy()))
            reg.gauge("serve.prefix_hits").set(
                sum(r.pool.prefix_hits
                    for r in self.router.replicas.values()))

    def run(self, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Drive ``step`` until every request is DONE (or FAILED past its
        retry budget); returns rid -> greedy tokens."""
        if max_steps is None:
            budget = sum(r.max_new_tokens
                         for r in self.scheduler.requests.values())
            max_steps = 4 * budget + 200
        start = self.engine_step
        while not self.scheduler.all_done():
            if self.engine_step - start > max_steps:
                raise RuntimeError(
                    f"no completion after {max_steps} engine steps: "
                    f"{self.scheduler.pending()} queued, "
                    f"{len(self.scheduler.in_flight())} in flight")
            self.step()
        return self.results()

    def shutdown(self) -> None:
        self.router.shutdown()
        if self.monitor is not None:
            self.monitor.stop()

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _record(self, event: str, **kw) -> None:
        self.obs.emit("serve", event, step=self.engine_step, **kw)

    def _drain_detected(self) -> None:
        for rid in self.router.take_detected():
            self._fail(self.router.replicas[rid], "heartbeat-timeout")

    def _fail(self, rep: Replica, reason: str) -> None:
        t0 = time.perf_counter()
        drained = self.router.fail_replica(rep, reason)
        # requeue in REVERSE row order: each requeue prepends, so the
        # reversed walk leaves the queue front in row (= admission) order
        for r in reversed(drained):
            self.scheduler.requeue(self.scheduler.requests[r])
        drain_s = time.perf_counter() - t0
        extra = {}
        if self.paged and rep.pool.last_drain is not None:
            extra = {"pages_drained": rep.pool.last_drain["pages_freed"],
                     "prefix_entries_dropped":
                         rep.pool.last_drain["prefix_entries"]}
        self._record("replica_failed", replica=rep.id, reason=reason,
                     drained=len(drained), hosts=list(rep.hosts), **extra)
        reg = self.obs.registry
        reg.histogram("serve.failover_drain_ms").observe(drain_s * 1e3)
        reg.counter("serve.replica_failures").inc()
        reg.counter("serve.requests_drained").inc(len(drained))
        if self.router.standby_count:
            standby = self.router.activate_standby()
            if standby is not None:
                self._record("standby_activated", replica=standby.id)

    def _pre_drain_risky(self) -> None:
        """The telemetry plane's proactive path: drain a replica whose
        host risk crossed the threshold — BEFORE its failure is
        detected — while capacity exists to absorb it."""
        scores = self.risk_source()
        for host, risk in sorted(scores.items()):
            if risk < self.pre_drain_threshold:
                continue
            rid = self.router._host_to_rid.get(host)
            if rid is None:
                continue
            rep = self.router.replicas[rid]
            if not rep.healthy:
                continue
            # never drain the last line of service: require a surviving
            # healthy replica or a warm standby to absorb the requeue
            others = [r for r in self.router.healthy() if r.id != rid]
            if not others and not self.router.standby_count:
                continue
            drained = self.router.drain_replica(rep, f"risk={risk:.2f}")
            for r in reversed(drained):
                self.scheduler.requeue(self.scheduler.requests[r])
            self._record("replica_predrained", replica=rep.id,
                         hosts=list(rep.hosts), risk=risk,
                         drained=len(drained))
            reg = self.obs.registry
            reg.counter("serve.replica_predrains").inc()
            reg.counter("serve.requests_drained").inc(len(drained))
            if self.router.standby_count:
                standby = self.router.activate_standby()
                if standby is not None:
                    self._record("standby_activated",
                                 replica=standby.id)

    def _step_replica(self, rep: Replica) -> None:
        # t0 BEFORE the injector: an injected latency spike sleeps in
        # check_replica, and the emitted step timing must include it —
        # that stretch is exactly what the drift detector watches
        t0 = time.perf_counter()
        if self.injector is not None:
            # may raise SimulatedFailure (replica kill) or
            # CorruptionDetected (replica SDC), or sleep (latency spike)
            self.injector.check_replica(self.engine_step, rep.id)
        self._admit(rep)
        self._decode(rep)
        if self.risk_source is not None and rep.hosts:
            # host-attributed step timing for the drift detector (the
            # decode ends in a copy of the tokens to the host, so the
            # card's work is inside it); the "telemetry" subsystem keeps
            # it out of the serve-subsystem .events view
            self.obs.emit("telemetry", "replica_step", replica=rep.id,
                          host=rep.hosts[0],
                          seconds=time.perf_counter() - t0)

    def _admit(self, rep: Replica) -> None:
        if self.paged:
            self._admit_paged(rep)
            return
        admitted = 0
        while (rep.pool.free_count > 0 and self.scheduler.pending() > 0
               and admitted < self.max_prefill_per_step):
            req = self.scheduler.pop_queued()
            slot = rep.pool.acquire(req.rid)
            self.scheduler.start_prefill(req, slot, rep.id)
            tok0, row = rep.prefill(req.prompt)
            rep.pool.write_row(slot, row)
            self._first_token(rep, req, slot, tok0)
            admitted += 1

    def _admit_paged(self, rep: Replica) -> None:
        """Page-aware admission: a request leaves the queue only when the
        pool can cover its prompt pages AND a worst-case-growth
        reservation.  An exact full-prompt prefix hit skips the prefill:
        the cached pages attach read-only and the stream opens with the
        stored first greedy token."""
        admitted = 0
        pool = rep.pool
        while (self.scheduler.pending() > 0
               and admitted < self.max_prefill_per_step):
            nxt = self.scheduler.peek_queued()
            if not pool.can_admit(nxt.prompt, nxt.max_new_tokens):
                break
            req = self.scheduler.pop_queued()
            try:
                row, plan = pool.acquire(req.rid, req.prompt,
                                         req.max_new_tokens)
            except PageExhausted:
                # an entry pinned by the plan can still starve the
                # reclaimable estimate: put the request back untouched
                self.scheduler._queue.appendleft(req.rid)
                break
            self.scheduler.start_prefill(req, row, rep.id)
            if plan.skip_prefill:
                tok0 = plan.first_token
                self._record("prefix_hit", rid=req.rid,
                             shared_pages=plan.shared, full=True)
            else:
                tok0, row_cache = rep.prefill(req.prompt)
                pool.write_prefill(row, row_cache)
                pool.register_prefix(row, req.prompt, tok0)
                if plan.shared:
                    self._record("prefix_hit", rid=req.rid,
                                 shared_pages=plan.shared, full=False)
            self._first_token(rep, req, row, tok0)
            admitted += 1

    def _first_token(self, rep: Replica, req, row: int, tok0: int) -> None:
        self.scheduler.start_decode(req, tok0)
        req.t_first_token = time.perf_counter()
        self.obs.registry.histogram("serve.ttft_ms").observe(
            (req.t_first_token - req.t_submit) * 1e3)
        if req.retries > 0:
            self._record("retry_first_token", rid=req.rid,
                         retries=req.retries)
        if req.remaining == 0:           # max_new_tokens == 1
            self._finish(rep, req, row)

    def _decode(self, rep: Replica) -> None:
        if self.paged:
            self._make_writable(rep)
        active = rep.pool.active_slots
        if not active:
            return
        last = np.zeros((self.fns.num_rows,), np.int64)
        for row in active:
            req = self.scheduler.requests[rep.pool.owner(row)]
            if req.state != DECODE:
                raise RuntimeError(f"request {req.rid} in row {row} is "
                                   f"{req.state}, not decoding")
            last[row] = req.last_token
        toks, stats = rep.decode(last)
        if rep.sentinel is not None:
            nonfinite = float(np.max(stats["nonfinite"].reshape(-1)[active]))
            entropy = float(np.mean(stats["entropy"].reshape(-1)[active]))
            reason = rep.sentinel.observe(self.engine_step, nonfinite,
                                          entropy)
            if reason is not None:
                # the step's tokens are suspect: discard them, fail the
                # replica (its requests retry on a survivor)
                raise CorruptionDetected(self.engine_step,
                                         "decode-sentinel", reason)
        now = time.perf_counter()
        self.obs.registry.counter("serve.tokens").inc(len(active))
        for row in active:
            req = self.scheduler.requests[rep.pool.owner(row)]
            if self.paged:
                rep.pool.advance(row)    # this step wrote position len
            if self.scheduler.append_token(req, int(toks[row])):
                self._finish(rep, req, row, now=now)

    def _make_writable(self, rep: Replica) -> None:
        # make each active row's write-target page exclusively owned
        # BEFORE the batched step (grow, or copy-on-write a shared tail);
        # PageExhausted here means reservation accounting was bypassed —
        # a PLANNED requeue (no retry burned, no incident)
        for row in list(rep.pool.active_slots):
            req = self.scheduler.requests[rep.pool.owner(row)]
            try:
                rep.pool.ensure_writable(row)
            except PageExhausted:
                rep.pool.release(row)
                self.scheduler.requeue(req, planned=True)
                self._record("page_requeue", rid=req.rid, row=row)
                self.obs.registry.counter("serve.page_requeues").inc()

    def _finish(self, rep: Replica, req, row: int,
                now: Optional[float] = None) -> None:
        self.scheduler.finish(req)
        rep.pool.release(row)
        req.t_done = time.perf_counter() if now is None else now
        self.obs.registry.histogram("serve.latency_ms").observe(
            (req.t_done - req.t_submit) * 1e3)
        self.obs.registry.counter("serve.requests_done").inc()
