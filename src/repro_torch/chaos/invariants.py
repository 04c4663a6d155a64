"""Standing invariants every chaos run must hold (the reference's
``chaos/invariants.py``).

Each ``check_*`` returns an ``InvariantResult`` (never raises), so a bench
can report pass RATES across a scenario library; ``verify`` turns a result
list into hard assertions for tests.  The catalog (docs/chaos.md):

- **zero-drop**: every admitted request finishes DONE — failover may retry,
  admission control may reject at submit, but nothing admitted is lost.
- **token-identical**: retried greedy streams match the uninterrupted
  reference token for token (greedy decode is a pure function of the
  prompt).
- **trajectory-match**: the training loss history after rollback/reshard
  matches the uninterrupted reference (bit-exact on one mesh; within a
  tolerance across mesh widths — bf16 cross-mesh reduction-order noise).
- **no-lost-steps**: one loss record per superstep, none repeated.
- **no-dead-growth**: the mesh never grows onto a host that was dead at
  grow time (the (inc, seq) rejoin-ordering guarantee).
- **monotonic-drain**: drained-request accounting only ever increases, and
  submitted == completed + queued + in-flight + rejected at every sample.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class InvariantViolation(AssertionError):
    """A chaos invariant did not hold (raised by ``verify``)."""


@dataclasses.dataclass(frozen=True)
class InvariantResult:
    name: str
    passed: bool
    detail: str = ""

    def __bool__(self) -> bool:
        return self.passed


def _ok(name: str, detail: str = "") -> InvariantResult:
    return InvariantResult(name, True, detail)


def _bad(name: str, detail: str) -> InvariantResult:
    return InvariantResult(name, False, detail)


# ---------------------------------------------------------------------------
# serving plane
# ---------------------------------------------------------------------------

def check_zero_drop(scheduler, submitted_rids: Optional[Iterable[int]] = None
                    ) -> InvariantResult:
    """Every admitted request reached DONE.  ``scheduler`` is the engine's
    ``Scheduler`` (or any object with ``requests``/``failed_rids``);
    ``submitted_rids`` defaults to every request the scheduler has seen.
    Call before results are reaped (reaping evicts the records)."""
    failed = sorted(set(scheduler.failed_rids))
    if failed:
        return _bad("zero-drop", f"{len(failed)} requests FAILED past "
                    f"their retry budget: {failed[:8]}")
    rids = (set(submitted_rids) if submitted_rids is not None
            else set(scheduler.requests))
    lost = sorted(r for r in rids if r not in scheduler.requests)
    if lost:
        return _bad("zero-drop", f"{len(lost)} submitted requests have no "
                    f"record at all: {lost[:8]}")
    not_done = sorted(r for r in rids
                      if scheduler.requests[r].state != "DONE")
    if not_done:
        return _bad("zero-drop", f"{len(not_done)} requests not DONE: "
                    f"{not_done[:8]}")
    return _ok("zero-drop", f"{len(rids)} requests all DONE")


def check_token_identical(results: Dict[int, List[int]],
                          reference: Dict[int, List[int]]
                          ) -> InvariantResult:
    """Every stream in ``results`` matches ``reference`` token for token
    (retried requests included — that is the failover determinism
    guarantee)."""
    missing = sorted(set(reference) - set(results))
    if missing:
        return _bad("token-identical",
                    f"streams missing from results: {missing[:8]}")
    for rid in sorted(reference):
        if list(results[rid]) != list(reference[rid]):
            return _bad("token-identical",
                        f"stream {rid} diverged: got {results[rid][:8]}... "
                        f"want {reference[rid][:8]}...")
    return _ok("token-identical", f"{len(reference)} streams bit-exact")


# ---------------------------------------------------------------------------
# training plane
# ---------------------------------------------------------------------------

def check_trajectory_match(losses: Sequence[float],
                           ref_losses: Sequence[float],
                           tol: float = 0.15) -> InvariantResult:
    """Loss trajectory matches the uninterrupted reference within ``tol``
    per step (``tol=0`` demands bit-exact — same mesh, bit-exact
    rollback)."""
    if len(losses) != len(ref_losses):
        return _bad("trajectory-match",
                    f"{len(losses)} loss records vs {len(ref_losses)} "
                    "reference steps")
    for i, (a, b) in enumerate(zip(losses, ref_losses)):
        if (a != b) if tol == 0 else (abs(a - b) > tol):
            return _bad("trajectory-match",
                        f"step {i}: loss {a} vs reference {b} "
                        f"(tol={tol})")
    return _ok("trajectory-match", f"{len(losses)} steps within {tol}")


def check_no_lost_steps(history: Sequence[Dict], num_steps: int
                        ) -> InvariantResult:
    """Exactly one loss record per superstep 1..num_steps — failover
    replay must neither skip nor double-count a step in the merged
    history."""
    steps = [h["step"] for h in history if "loss" in h]
    want = list(range(1, num_steps + 1))
    if steps != want:
        return _bad("no-lost-steps", f"superstep records {steps[:12]}... "
                    f"!= 1..{num_steps}")
    return _ok("no-lost-steps", f"{num_steps} supersteps, each exactly once")


def check_no_dead_growth(grow_events: Sequence[Tuple[float, Sequence[int]]],
                         dead_intervals: Dict[int, List[Tuple[float, float]]]
                         ) -> InvariantResult:
    """No grow event added a host that was dead when it fired.

    ``grow_events``: [(t, hosts_added)]; ``dead_intervals``: host ->
    [(t_dead, t_alive_again)] with ``float('inf')`` for never-rejoined.
    The heartbeat layer's (inc, seq) ordering is what makes this hold:
    a stale in-flight datagram from a dead host must not read as a
    rejoin."""
    for t, hosts in grow_events:
        for h in hosts:
            for dead_at, alive_at in dead_intervals.get(h, ()):
                if dead_at <= t < alive_at:
                    return _bad("no-dead-growth",
                                f"grow at t={t} added host {h}, dead over "
                                f"[{dead_at}, {alive_at})")
    return _ok("no-dead-growth", f"{len(grow_events)} grow events clean")


# ---------------------------------------------------------------------------
# accounting (serving + simulator)
# ---------------------------------------------------------------------------

def check_monotonic_drain(drained_series: Sequence[int]) -> InvariantResult:
    """Cumulative drained-request count never decreases (a decrement means
    a drained request vanished from the accounting)."""
    for i in range(1, len(drained_series)):
        if drained_series[i] < drained_series[i - 1]:
            return _bad("monotonic-drain",
                        f"drained count fell {drained_series[i - 1]} -> "
                        f"{drained_series[i]} at sample {i}")
    return _ok("monotonic-drain", f"{len(drained_series)} samples "
               "non-decreasing")


def check_conservation(samples: Sequence[Dict[str, int]]) -> InvariantResult:
    """At every sample: submitted == completed + queued + in_flight +
    rejected.  A leak on either side is a dropped or duplicated request."""
    for i, s in enumerate(samples):
        have = (s["completed"] + s["queued"] + s["in_flight"]
                + s.get("rejected", 0))
        if have != s["submitted"]:
            return _bad("request-conservation",
                        f"sample {i}: submitted={s['submitted']} but "
                        f"accounted={have} ({s})")
    return _ok("request-conservation", f"{len(samples)} samples balanced")


def check_page_conservation(samples: Sequence[Dict[str, int]]
                            ) -> InvariantResult:
    """Paged-KV accounting (serve/page_table.py): at every sample,
    free + held == total, reservations never exceed the free list, and
    the pool's refcount audit came back clean — across admissions, prefix
    sharing, copy-on-write, and ``release_all`` drains.  A violation is a
    page leak or double-free.  Samples come from
    ``ServeEngine.page_conservation()`` (``ServeScenarioDriver`` records
    one per step in ``page_samples``)."""
    if not samples:
        return _bad("page-conservation",
                    "no page samples recorded (engine not paged?)")
    for i, s in enumerate(samples):
        if s["pages_free"] + s["pages_held"] != s["pages_total"]:
            return _bad("page-conservation",
                        f"sample {i}: free={s['pages_free']} + "
                        f"held={s['pages_held']} != "
                        f"total={s['pages_total']}")
        if s["pages_reserved"] > s["pages_free"]:
            return _bad("page-conservation",
                        f"sample {i}: {s['pages_reserved']} pages "
                        f"reserved but only {s['pages_free']} free")
        if not s["refs_ok"]:
            return _bad("page-conservation",
                        f"sample {i}: refcount audit failed ({s})")
    return _ok("page-conservation", f"{len(samples)} samples balanced")


# ---------------------------------------------------------------------------
# telemetry plane
# ---------------------------------------------------------------------------

#: proactive actions the telemetry plane takes on a precursor
ACT_KINDS = (("checkpoint", "proactive"), ("serve", "replica_predrained"))


def check_detect_before_act(events) -> InvariantResult:
    """The telemetry plane's detect -> act ordering (docs/observability.md):

    - at least one ``precursor/*`` event fired (the detectors saw the
      staged symptom at all);
    - every proactive ACT — a forced checkpoint (``checkpoint/proactive``)
      or a serve pre-drain (``serve/replica_predrained``) — happens at or
      after the first precursor (nothing acts on a prediction that does
      not exist yet);
    - every observed failure of a host a precursor named — a
      ``heartbeat/failure`` for that host, or a ``serve/replica_failed``
      whose ``hosts`` include it — happens after that host's first
      precursor: the plane predicted the failures it claims to predict.

    ``events`` is any ``Event`` sequence (bus ring, collector merge, or
    ``load_jsonl``)."""
    name = "detect-before-act"
    evs = sorted(events, key=lambda e: (e.t_mono, e.seq))
    first_any: Optional[float] = None
    first_by_host: Dict[int, float] = {}
    for e in evs:
        if e.subsystem == "precursor":
            if first_any is None:
                first_any = e.t_mono
            h = e.data.get("host")
            if h is not None:
                first_by_host.setdefault(int(h), e.t_mono)
    if first_any is None:
        return _bad(name, "no precursor/* event fired")
    for e in evs:
        if (e.subsystem, e.kind) in ACT_KINDS and e.t_mono < first_any:
            return _bad(name,
                        f"{e.subsystem}/{e.kind} at t={e.t_mono:.3f} "
                        f"precedes the first precursor "
                        f"(t={first_any:.3f})")
    for e in evs:
        hosts: List[int] = []
        if (e.subsystem, e.kind) == ("heartbeat", "failure") and \
                e.data.get("host") is not None:
            hosts = [int(e.data["host"])]
        elif (e.subsystem, e.kind) == ("serve", "replica_failed"):
            hosts = [int(h) for h in e.data.get("hosts", ())]
        for h in hosts:
            if h in first_by_host and e.t_mono < first_by_host[h]:
                return _bad(name,
                            f"host {h} failed at t={e.t_mono:.3f} "
                            f"before its first precursor "
                            f"(t={first_by_host[h]:.3f})")
    acts = sum(1 for e in evs if (e.subsystem, e.kind) in ACT_KINDS)
    return _ok(name, f"{sum(1 for e in evs if e.subsystem == 'precursor')}"
               f" precursors before {acts} proactive acts")


# ---------------------------------------------------------------------------
# suite helpers
# ---------------------------------------------------------------------------

def verify(results: Iterable[InvariantResult]) -> List[InvariantResult]:
    """Raise ``InvariantViolation`` listing every failed invariant;
    returns the results when all pass (test-side entry point)."""
    results = list(results)
    failed = [r for r in results if not r.passed]
    if failed:
        raise InvariantViolation(
            "; ".join(f"{r.name}: {r.detail}" for r in failed))
    return results


def pass_rate(results: Iterable[InvariantResult]) -> float:
    results = list(results)
    if not results:
        return 1.0
    return sum(1 for r in results if r.passed) / len(results)


def summarize(results: Iterable[InvariantResult]) -> Dict[str, bool]:
    """name -> passed map for machine-readable bench output."""
    return {r.name: r.passed for r in results}
