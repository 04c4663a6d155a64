"""BSP training coordinator: the paper's protected iterative loop (the
reference's ``core/coordinator.py``).

``run_bsp`` executes supersteps with interruption detection + data
preservation at step boundaries.  ``run_with_recovery`` wraps it with
fail-stop and silent-data-corruption recovery: a (simulated or real)
failure triggers restore from the last committed checkpoint and
continuation; a CorruptionDetected from an SDC tier (the scrubber or
the loss sentinel) triggers rollback to the newest checksum-verified
checkpoint.  Every
rollback/restart is an event in the returned history.

SDC hooks inside each superstep (no-ops unless enabled):
  - ``fault_injector.apply_sdc`` at the top: scheduled bit-flips strike
    the state at rest, inside the scrubber's record -> verify window;
  - ``dep.verify_state`` right after: re-checksums the leaves the previous
    superstep's scrub recorded;
  - ``dep.scrub`` after the step: checksums the next rotating subset of
    the fresh state;
  - ``dep.check_metrics``: the tier-3 loss sentinel.

With an ``Observability`` attached to the facade every superstep emits a
``train/step`` event (the drift detector's input) and observes
``train.step_ms``; recovery emits ``train/interrupted`` and
``train/resume``, the detection and repair marks of a ``Timeline``
incident.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.api import Dependability
from repro_torch.core.failures import (CorruptionDetected, FaultInjector,
                                       SimulatedFailure)
from repro_torch.train.step import metrics_to_host


def run_bsp(dep: Dependability, train_step: Callable, state, data,
            num_steps: int, *, fault_injector: Optional[FaultInjector] = None,
            on_metrics: Optional[Callable[[int, Dict], None]] = None,
            stop_check: Optional[Callable[[], Optional[str]]] = None,
            proactive: Optional[Callable[[int], Optional[str]]] = None,
            final_save: bool = True) -> Tuple[Any, str, List[Dict]]:
    """Runs supersteps until ``num_steps`` or interruption.

    Returns (state, status, history); status in {"done", "interrupted",
    "paused:<reason>"} (an interruption or a pause takes a final save
    first unless ``final_save`` is False).  ``stop_check`` is polled at
    each step boundary: a non-None reason pauses the loop exactly like an
    interruption but reports the reason — the elastic layer stops so for
    mesh changes (a failed host, a rejoining one).  ``proactive`` is the telemetry plane's precursor hook
    (``repro_torch.obs.make_proactive_hook``): polled after each
    superstep when the policy cadence does NOT already save; a non-None
    reason forces a checkpoint now, ahead of the failure the precursors
    predict.  Forced saves flow through ``dep.save`` like any other, so
    they re-anchor the policy cadence.  May raise SimulatedFailure
    (injected fail-stop) or CorruptionDetected (an SDC tier tripped) —
    run_with_recovery handles both."""
    history: List[Dict] = []
    step = int(state["step"])
    while step < num_steps:
        pause = stop_check() if stop_check is not None else None
        if dep.interrupted() or pause is not None:
            if final_save:
                dep.save(step, state, final=True)
            # the final save may have queued behind a still-running async
            # write: do not hand back control with the checkpoint in flight
            dep.manager.wait()
            status = "interrupted" if pause is None else f"paused:{pause}"
            return state, status, history

        if fault_injector is not None:
            # SDC strikes the at-rest state inside the record->verify window
            state = fault_injector.apply_sdc(step + 1, state)
        dep.verify_state(state, step + 1)      # may raise CorruptionDetected

        batch = data.next_batch()
        t0 = time.perf_counter()
        if fault_injector is not None:
            # fail-stop / straggle strikes DURING the superstep
            fault_injector.check(step + 1)     # may raise SimulatedFailure
        state, metrics = train_step(state, batch)
        metrics = metrics_to_host(metrics)     # block: end of superstep
        dt = time.perf_counter() - t0
        step += 1

        dep.scrub(state, step)                 # record the next scrub window
        straggler = dep.observe_step(dt, step)
        rec = {"step": step, "seconds": dt, "straggler": straggler,
               **metrics}
        history.append(rec)
        if dep.obs is not None:
            with dep.obs.timed():
                # one bus record per superstep: the drift detector's input
                dep.obs.emit("train", "step", **rec)
                dep.obs.registry.histogram("train.step_ms").observe(
                    dt * 1e3)
        if on_metrics:
            on_metrics(step, rec)
        dep.check_metrics(step, metrics)       # may raise CorruptionDetected

        if dep.should_checkpoint(step):
            dep.save(step, state)
        elif proactive is not None:
            # the hook's host time counts as the telemetry plane's
            with (dep.obs.timed() if dep.obs is not None
                  else contextlib.nullcontext()):
                why = proactive(step)
            if why is not None:
                dep.save(step, state)
                if dep.obs is not None:
                    with dep.obs.timed():
                        dep.obs.emit("checkpoint", "proactive", step=step,
                                     reason=why)
                        dep.obs.registry.counter(
                            "checkpoint.proactive").inc()
    dep.manager.wait()
    return state, "done", history


def run_with_recovery(dep: Dependability, train_step: Callable, state, data,
                      num_steps: int, *,
                      fault_injector: Optional[FaultInjector] = None,
                      max_restarts: int = 3, like=None,
                      on_metrics=None,
                      proactive: Optional[Callable[[int], Optional[str]]]
                      = None) -> Tuple[Any, Dict]:
    """Failure recovery loop: restore-from-checkpoint on fail-stop or
    detected corruption.

    ``like`` describes the state tree for restore and where its leaves go
    (defaults to the registered global template).  Corruption rollback
    restores the newest checksum-verified checkpoint that has not already
    failed to get past it (walking back past any whose CRCs no longer
    verify)."""
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
                fault_injector=fault_injector, on_metrics=on_metrics,
                proactive=proactive)
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
                if dep.obs is not None:
                    # SDC tiers emit their own detection inside
                    # verify_state/check_metrics; fail-stop is raised by
                    # the injector, so record the detection here
                    with dep.obs.timed():
                        dep.obs.emit("train", "interrupted", step=e.step,
                                     failure_kind=e.kind)
            restarts += 1
            if restarts > max_restarts:
                raise
            dep.manager.wait()
            if dep.world is not None:
                # every rank's last save has landed and host 0 committed
                dep.world.barrier("restore")
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
                if dep.obs is not None:
                    with dep.obs.timed():
                        dep.obs.registry.histogram(
                            "train.rollback_depth").observe(
                                max(0, e.step - got))
                        dep.obs.emit("train", "resume", step=got,
                                     rolled_back_from=e.step,
                                     restarts=restarts)
            except FileNotFoundError as fnf:
                # no (acceptable) checkpoint at all: restart from scratch
                all_history.append({"step": e.step,
                                    "event": f"restore:scratch:{fnf}"})
                state = state0
                if local0 is not None:
                    dep._local_provider.load_state_dict(local0)
                last_corrupt_restore = None
                if dep.obs is not None:
                    with dep.obs.timed():
                        dep.obs.emit("train", "resume", step=0,
                                     scratch=True, restarts=restarts)
            dep.reset_sdc()
