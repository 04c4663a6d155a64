"""Continuous-batching request scheduler: queue + per-request state machine.

Requests move through QUEUED -> PREFILL -> DECODE -> DONE; a replica
failure mid-flight drains its requests back to QUEUED (the RETRY
transition) with their partial output discarded, so the re-execution on a
survivor replays the greedy stream from scratch — token-identical to an
uninterrupted run, because each request's decode depends only on its own
prompt and cache row (see docs/serving.md, "Determinism").

Admission control is two-level: ``max_pending`` bounds the host-side
queue (``submit`` raises ``QueueFull`` beyond it — backpressure to the
caller), and slot availability in the replica's ``CachePool`` gates the
QUEUED -> PREFILL transition (a request never leaves the queue without a
cache slot to land in).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

QUEUED = "QUEUED"
PREFILL = "PREFILL"
DECODE = "DECODE"
DONE = "DONE"
FAILED = "FAILED"

_TRANSITIONS = {
    QUEUED: {PREFILL},
    PREFILL: {DECODE, QUEUED, DONE},   # -> QUEUED: replica died mid-prefill
    DECODE: {DONE, QUEUED},            # -> QUEUED: replica died mid-decode
    DONE: set(),
    FAILED: set(),
}


class QueueFull(RuntimeError):
    """Admission control rejected the request (queue at max_pending)."""


# retained tail of the observability lists (retried_rids/failed_rids and
# ServeEngine.events): unbounded growth under sustained traffic would be
# the same leak class reap() exists to close
OBSERVABILITY_CAP = 10_000


def _trim(lst: List) -> None:
    if len(lst) > OBSERVABILITY_CAP:
        del lst[:-OBSERVABILITY_CAP]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    state: str = QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    replica: Optional[int] = None
    retries: int = 0
    # engine-stamped perf_counter times for latency percentiles
    t_submit: float = 0.0
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.tokens)

    @property
    def last_token(self) -> int:
        return self.tokens[-1]


class Scheduler:
    def __init__(self, max_pending: int = 256, max_retries: int = 3):
        self.max_pending = max_pending
        self.max_retries = max_retries
        self.requests: Dict[int, Request] = {}
        self._queue: Deque[int] = deque()
        self._next_rid = 0
        self.retried_rids: List[int] = []      # observability: every requeue
        self.failed_rids: List[int] = []

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               t_submit: float = 0.0) -> Request:
        if len(self._queue) >= self.max_pending:
            raise QueueFull(
                f"{len(self._queue)} requests pending (max_pending="
                f"{self.max_pending})")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        req = Request(rid=self._next_rid, prompt=[int(t) for t in prompt],
                      max_new_tokens=max_new_tokens, t_submit=t_submit)
        self._next_rid += 1
        self.requests[req.rid] = req
        self._queue.append(req.rid)
        return req

    def pending(self) -> int:
        return len(self._queue)

    def peek_queued(self) -> Optional[Request]:
        """Front of the queue WITHOUT popping — page-aware admission must
        inspect the request's size (prompt + worst-case decode growth)
        before committing pages to it; a pop-then-push-back would reorder
        the FIFO against later requeues."""
        if not self._queue:
            return None
        return self.requests[self._queue[0]]

    def pop_queued(self) -> Optional[Request]:
        """Next request to prefill (FIFO), or None when the queue is empty.
        The caller must immediately transition it with ``start_prefill`` —
        popping without a cache slot in hand is a scheduling bug."""
        if not self._queue:
            return None
        return self.requests[self._queue.popleft()]

    # ------------------------------------------------------------------
    # state machine
    # ------------------------------------------------------------------
    def _transition(self, req: Request, to: str) -> None:
        if to not in _TRANSITIONS[req.state]:
            raise ValueError(f"request {req.rid}: illegal transition "
                             f"{req.state} -> {to}")
        req.state = to

    def start_prefill(self, req: Request, slot: int, replica: int) -> None:
        self._transition(req, PREFILL)
        req.slot = slot
        req.replica = replica

    def start_decode(self, req: Request, first_token: int) -> None:
        self._transition(req, DECODE)
        req.tokens.append(int(first_token))

    def append_token(self, req: Request, token: int) -> bool:
        """Record one decoded token; returns True when the request just
        reached its budget (caller finishes it and recycles the slot)."""
        if req.state != DECODE:
            raise ValueError(f"request {req.rid} not decoding ({req.state})")
        if req.remaining <= 0:
            raise ValueError(f"request {req.rid} already at budget")
        req.tokens.append(int(token))
        return req.remaining == 0

    def finish(self, req: Request) -> None:
        self._transition(req, DONE)
        req.slot = None
        req.replica = None

    def requeue(self, req: Request, planned: bool = False) -> None:
        """Drain a request off a dead/corrupt replica back to the queue.

        Partial output is discarded — greedy decode is a pure function of
        the prompt, so the retry regenerates the identical stream.  Retried
        requests go to the FRONT of the queue (they have already waited
        once).  Each call PREPENDS, so a caller requeuing a drained batch
        must walk it in reverse to keep the batch in slot order at the
        queue front (see ServeEngine._fail).

        ``planned=True`` marks a scheduler-initiated drain (page
        exhaustion under paging) rather than a failure: the request does
        not burn retry budget — a stream must never FAIL because the
        engine chose to requeue it — but it still counts in
        ``retried_rids`` so drain accounting stays monotonic."""
        if req.state not in (PREFILL, DECODE):
            raise ValueError(f"request {req.rid} not in flight ({req.state})")
        if not planned:
            req.retries += 1
        self.retried_rids.append(req.rid)
        # the pre-failure first token was discarded with the partial
        # output: leaving its timestamp in place would make a retried
        # request report its PRE-FAILURE TTFT and understate failover
        # latency — the retry restamps it when its stream actually starts
        req.t_first_token = None
        _trim(self.retried_rids)
        if req.retries > self.max_retries:
            req.state = FAILED
            req.slot = None
            req.replica = None
            self.failed_rids.append(req.rid)
            _trim(self.failed_rids)
            return
        self._transition(req, QUEUED)
        req.tokens = []
        req.slot = None
        req.replica = None
        self._queue.appendleft(req.rid)

    def reap(self, rid: int) -> Request:
        """Evict one finished (DONE/FAILED) request and return it.

        Without eviction ``requests`` grows without bound — the engine
        leaks one Request per served stream under sustained traffic.  Call
        after the result has been consumed; reaping an in-flight or queued
        request is a caller bug and raises."""
        req = self.requests.get(rid)
        if req is None:
            raise KeyError(f"request {rid} unknown (already reaped?)")
        if req.state not in (DONE, FAILED):
            raise ValueError(f"request {rid} not finished ({req.state}); "
                             "reap only after DONE/FAILED")
        del self.requests[rid]
        return req

    def reap_finished(self) -> List[Request]:
        """Evict and return every finished request (drain path for
        sustained serving: keeps ``requests`` bounded by in-flight+queued)."""
        done = [r.rid for r in self.requests.values()
                if r.state in (DONE, FAILED)]
        return [self.reap(rid) for rid in done]

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def in_flight(self, replica: Optional[int] = None) -> List[Request]:
        return [r for r in self.requests.values()
                if r.state in (PREFILL, DECODE)
                and (replica is None or r.replica == replica)]

    def all_done(self) -> bool:
        return all(r.state in (DONE, FAILED) for r in self.requests.values())

    def results(self) -> Dict[int, List[int]]:
        return {r.rid: list(r.tokens) for r in self.requests.values()
                if r.state == DONE}
