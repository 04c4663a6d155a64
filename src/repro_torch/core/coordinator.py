"""BSP training coordinator: the paper's protected iterative loop (the
reference's ``core/coordinator.py``).

``run_bsp`` executes supersteps with interruption detection + data
preservation at step boundaries.  ``run_with_recovery`` wraps it with
fail-stop and silent-data-corruption recovery: a (simulated or real)
failure triggers restore from the last committed checkpoint and
continuation; a CorruptionDetected from the loss sentinel triggers
rollback to an earlier checkpoint.  Every rollback/restart is an event in
the returned history.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.api import Dependability
from repro_torch.core.failures import (CorruptionDetected, FaultInjector,
                                       SimulatedFailure)
from repro_torch.train.step import metrics_to_host


def run_bsp(dep: Dependability, train_step: Callable, state, data,
            num_steps: int, *, fault_injector: Optional[FaultInjector] = None,
            on_metrics: Optional[Callable[[int, Dict], None]] = None
            ) -> Tuple[Any, str, List[Dict]]:
    """Runs supersteps until ``num_steps`` or interruption.

    Returns (state, status, history); status in {"done", "interrupted"}
    (an interruption takes a final save first).  May raise
    SimulatedFailure (injected fail-stop) or CorruptionDetected (the
    sentinel tripped) — run_with_recovery handles both.  The telemetry
    plane's stop and proactive-save hooks wait for ROADMAP items 8 and
    10."""
    history: List[Dict] = []
    step = int(state["step"])
    while step < num_steps:
        if dep.interrupted():
            dep.save(step, state, final=True)
            # the final save may have queued behind a still-running async
            # write: do not hand back control with the checkpoint in flight
            dep.manager.wait()
            return state, "interrupted", history

        batch = data.next_batch()
        t0 = time.perf_counter()
        if fault_injector is not None:
            # fail-stop / straggle strikes DURING the superstep
            fault_injector.check(step + 1)     # may raise SimulatedFailure
        state, metrics = train_step(state, batch)
        metrics = metrics_to_host(metrics)     # block: end of superstep
        dt = time.perf_counter() - t0
        step += 1

        straggler = dep.observe_step(dt, step)
        rec = {"step": step, "seconds": dt, "straggler": straggler,
               **metrics}
        history.append(rec)
        if on_metrics:
            on_metrics(step, rec)
        dep.check_metrics(step, metrics)       # may raise CorruptionDetected

        if dep.should_checkpoint(step):
            dep.save(step, state)
    dep.manager.wait()
    return state, "done", history


def run_with_recovery(dep: Dependability, train_step: Callable, state, data,
                      num_steps: int, *,
                      fault_injector: Optional[FaultInjector] = None,
                      max_restarts: int = 3, like=None,
                      on_metrics=None) -> Tuple[Any, Dict]:
    """Failure recovery loop: restore-from-checkpoint on fail-stop or
    detected corruption.

    ``like`` describes the state tree for restore and where its leaves go
    (defaults to the registered global template).  Corruption rollback
    restores the newest checkpoint saved before the trip that has not
    already failed to get past it."""
    restarts = 0
    all_history: List[Dict] = []
    state0 = state                           # scratch-restart fallback
    local0 = (dep._local_provider.state_dict()
              if dep._local_provider is not None else None)
    corrupt_exclude: set = set()
    last_corrupt_restore = None              # (step, saves seen at restore)
    while True:
        try:
            state, status, hist = run_bsp(
                dep, train_step, state, data, num_steps,
                fault_injector=fault_injector, on_metrics=on_metrics)
            all_history.extend(hist)
            return state, {"status": status, "restarts": restarts,
                           "history": all_history}
        except (SimulatedFailure, CorruptionDetected) as e:
            is_corruption = isinstance(e, CorruptionDetected)
            if is_corruption:
                all_history.append({
                    "step": e.step,
                    "event": f"corruption:{e.kind}:{e.detail}"})
            else:
                all_history.append({"step": e.step,
                                    "event": f"failure:{e.kind}"})
            restarts += 1
            if restarts > max_restarts:
                raise
            dep.manager.wait()
            if (is_corruption and last_corrupt_restore is not None
                    and len(dep.save_history) == last_corrupt_restore[1]):
                # corruption re-tripped without a single new checkpoint:
                # the checkpoint we rolled back to is itself suspect —
                # walk one further back instead of livelocking on it
                corrupt_exclude.add(last_corrupt_restore[0])
            # drop the failed run's state before the restore allocates the
            # restored one (the scratch fallback stays in state0)
            state = None
            try:
                state, got = dep.restore_latest(
                    like=like,
                    exclude=corrupt_exclude if is_corruption else None)
                if dep.last_restore_skipped:
                    all_history.append({
                        "step": got, "event": "restore:skipped:" + ",".join(
                            str(s) for s, _ in dep.last_restore_skipped)})
                if is_corruption:
                    last_corrupt_restore = (got, len(dep.save_history))
            except FileNotFoundError as fnf:
                # no (acceptable) checkpoint at all: restart from scratch
                all_history.append({"step": e.step,
                                    "event": f"restore:scratch:{fnf}"})
                state = state0
                if local0 is not None:
                    dep._local_provider.load_state_dict(local0)
                last_corrupt_restore = None
