"""The paper's case study: DeLIA-protected 4-D full-waveform inversion
with LOCAL-SCOPE checkpointing on, the configuration the paper could not
validate; the port's twin of the reference's ``examples/fwi_case_study.py``
and of the overhead measurement of ``benchmarks/bench_overhead_fwi.py``.

    PYTHONPATH=src python -m repro_torch.apps.fwi_case_study [--device cpu]

Inverts a baseline and a monitor survey (a time-lapse pair) with the
dependability layer on: saves every iteration, a fail-stop injected into
the baseline survey and recovered.  Shots are spread over ``dp_width``
shards; each shard's cursor and shot slice checkpoint to their own
``local_s<k>.json`` file, and every shard file is checked on restore.
Prints the 4-D difference image's statistics, then the checkpoint
overhead by the paper's eq. 2, ``(M_with - M_without) / M_with`` over
the medians M of timed runs each: saves every iteration synchronous,
asynchronous, and asynchronous with the int8 codec.  Where the runs
spread more than the saves cost, the medians cannot resolve eq. 2: the
share of a run the saves held the loop is printed as its estimate, with
the bound an async writer's time beside the loop puts on it.  The model
runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time
from dataclasses import replace
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.apps.fwi import (FWIConfig, FWIShardData,
                                  make_observed_data, run_fwi)
from repro_torch.core import Dependability, DependabilityConfig, FaultInjector
from repro_torch.device import resolve_device

# the reference's case study (examples/fwi_case_study.py): 70 x 70, nt 400,
# 3 shots a survey over 3 shot shards, 14 iterations, a fail-stop at 6;
# eq. 2 over 3 runs of 4 iterations a configuration
CASE = FWIConfig(nz=70, nx=70, nt=400, n_shots=3, iterations=14)
DP_WIDTH = 3
FAIL_AT = 6
OVERHEAD_RUNS = 3
OVERHEAD_ITERS = 4

# the facade configurations of the overhead measurement: every one saves
# every iteration (the paper's setting, eq. 3's largest overhead)
SAVE_CONFIGS: Dict[str, Dict] = {
    "sync_every_iter": {"async_save": False},
    "async_every_iter": {"async_save": True},
    "async_int8": {"async_save": True, "codec": "int8"},
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def protect(ckpt_dir: str, **config) -> Dependability:
    """A started facade saving every iteration into ``ckpt_dir``, with
    termination-signal detection on as in the reference's case study and
    overhead benchmark: its handlers are installed until ``stop()``, so
    call it from the main thread (``signal.signal`` takes no other)."""
    return Dependability(DependabilityConfig(
        checkpoint_dir=ckpt_dir, policy_mode="every_n", every_n=1,
        heartbeat=False, signal_detection=True, **config)).start()


def timed_run(cfg: FWIConfig, d_obs, *, device,
              config: Optional[Dict] = None,
              shot_group: Optional[int] = None,
              ckpt_root: Optional[str] = None):
    """One inversion from the initial model, timed from its start to its
    last save on disk (the async writer drained); with ``config`` it runs
    through a fresh facade of that configuration.  Returns (seconds,
    final state, seconds its saves held the loop: each save's snapshot,
    and its write when the save blocks; seconds an async writer ran
    beside the loop: its writes)."""
    with tempfile.TemporaryDirectory(dir=ckpt_root) as d:
        dep = protect(d, **config) if config is not None else None
        try:
            _sync(device)
            t0 = time.perf_counter()
            state, _ = run_fwi(cfg, d_obs, dep=dep, device=device,
                               shot_group=shot_group)
            _sync(device)
            if dep is not None:
                dep.manager.wait()
            seconds = time.perf_counter() - t0
            saves = dep.save_history if dep is not None else ()
            held = sum(st.snapshot_seconds
                       + (st.write_seconds if st.blocking else 0.0)
                       for st in saves)
            beside = sum(st.write_seconds for st in saves if not st.blocking)
            return seconds, state, held, beside
        finally:
            if dep is not None:
                dep.stop()


def overhead(cfg: FWIConfig, d_obs, *, runs: int, device,
             shot_group: Optional[int] = None,
             ckpt_root: Optional[str] = None):
    """The paper's eq. 2 for each of ``SAVE_CONFIGS`` against runs without
    the facade: ``(median_with - median_without) / median_with`` over
    ``runs`` runs of each, taken in turns (without, sync, async, int8,
    without, ...) so that a drift of the host's speed reaches every
    configuration alike (``eq2_raw``); and whether every configuration's
    final model equals the unprotected run's bit for bit (saving must not
    change the inversion).

    ``eq2_raw`` is resolved only where it exceeds the runs' spread: the
    range of every run of every configuration against the unprotected
    median, ``(max - min) / median_without``.  Where saving costs less
    than the runs vary, every run is a draw from one distribution, and a
    difference of medians inside its range says nothing.  Beside it, each
    configuration's median share of a run that its saves held the loop
    (``held_share``, the estimate of eq. 2: the save cost alone, free of
    the loop's run-to-run spread) and the share an async writer ran beside
    the loop (``writer_share``).  The writer can slow the loop (host cores,
    the interpreter lock) only while it runs, so ``held_share +
    writer_share`` bounds eq. 2 (``eq2_bound``); ``eq2_raw`` above it is
    spread, not the writer.  Returns (that report, the unprotected run's
    final state)."""
    configs = {"without": None, **SAVE_CONFIGS}
    seconds: Dict[str, List[float]] = {name: [] for name in configs}
    held: Dict[str, List[float]] = {name: [] for name in configs}
    beside: Dict[str, List[float]] = {name: [] for name in configs}
    finals = {}
    for _ in range(runs):
        for name, config in configs.items():
            t, finals[name], h, w = timed_run(
                cfg, d_obs, device=device, config=config,
                shot_group=shot_group, ckpt_root=ckpt_root)
            seconds[name].append(t)
            held[name].append(h / t)
            beside[name].append(w / t)
    base_state = finals["without"]
    every = [t for ts in seconds.values() for t in ts]
    m_base = statistics.median(seconds["without"])
    spread = (max(every) - min(every)) / m_base
    out = {"runs": runs, "iterations": cfg.iterations, "spread": spread,
           "without": {"median_s": m_base, "seconds": seconds["without"]}}
    for name in SAVE_CONFIGS:
        med = statistics.median(seconds[name])
        raw = (med - m_base) / med
        held_share = statistics.median(held[name])
        writer_share = statistics.median(beside[name])
        out[name] = {"median_s": med, "seconds": seconds[name],
                     "eq2_raw": raw, "eq2_resolved": abs(raw) > spread,
                     "held_share": held_share,
                     "writer_share": writer_share,
                     "eq2_bound": held_share + writer_share,
                     "c_bit_equal": bool(torch.equal(
                         finals[name]["params"]["c"],
                         base_state["params"]["c"]))}
    return out, base_state


def survey(cfg: FWIConfig, d_obs, *, dp_width: int, fail_at: int, device,
           ckpt_dir: str, shot_group: Optional[int] = None,
           on_metrics: Optional[Callable] = None) -> Dict:
    """One survey inverted in local scope over ``dp_width`` shot shards,
    async saves every iteration, with a fail-stop at ``fail_at`` (0: none).
    Every shard file of the last checkpoint is read back and must tile the
    shots; they are then remapped onto half the width (at least 1)."""
    dep = protect(ckpt_dir, async_save=True)
    injector = None
    if fail_at:
        injector = FaultInjector()
        injector.schedule_failstop(fail_at)
    try:
        t0 = time.perf_counter()
        state, hist = run_fwi(cfg, d_obs, dep=dep, fault_injector=injector,
                              local_scope=True, dp_width=dp_width,
                              device=device, shot_group=shot_group,
                              on_metrics=on_metrics)
        _sync(device)
        dep.manager.wait()
        wall = time.perf_counter() - t0
        last = dep.manager.latest_step()
        files = sorted(f for f in os.listdir(
            os.path.join(ckpt_dir, f"step_{last:08d}"))
            if f.startswith("local_s"))
        shards = dep.manager.restore_local_shards(last)
    finally:
        dep.stop()
    if len(files) != dp_width or len(shards) != dp_width:
        raise RuntimeError(f"local scope: {len(files)} shard files, "
                           f"{len(shards)} restored, width {dp_width}")
    remap = FWIShardData(d_obs, dp_width=max(1, dp_width // 2))
    remap.load_shard_state_dicts(shards)          # raises unless they tile
    return {"state": state, "history": hist, "wall_s": wall,
            "shard_files": files,
            "spans": [(d["shot_lo"], d["shot_hi"]) for d in shards],
            "remapped": {"from": remap.remapped_from,
                         "spans": remap.spans, "step": remap.step},
            "events": [h["event"] for h in hist if "event" in h]}


def difference_image(data: Dict, c_base: torch.Tensor,
                     c_mon: torch.Tensor) -> Dict:
    """The inverted 4-D difference against the true anomaly: mean |diff|
    inside and outside it (m/s)."""
    diff = (c_mon - c_base).double()
    true_diff = (data["model_monitor"] - data["model_baseline"]).double()
    anomaly = true_diff != 0
    return {"inside_mean_abs": float(diff[anomaly].abs().mean()),
            "outside_mean_abs": float(diff[~anomaly].abs().mean()),
            "true_anomaly": float(true_diff.min()),
            "anomaly_cells": int(anomaly.sum())}


def main(argv=None, cfg: FWIConfig = CASE) -> int:
    """The case study at ``cfg`` (the reference's by default; Python
    callers may pass a smaller one with more than ``FAIL_AT``
    iterations)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    print("synthesizing observed data (baseline + monitor surveys)...")
    data = make_observed_data(cfg, device)
    results = {}
    for name in ("baseline", "monitor"):
        fail = FAIL_AT if name == "baseline" else 0
        with tempfile.TemporaryDirectory() as d:
            r = survey(cfg, data[name], dp_width=DP_WIDTH, fail_at=fail,
                       device=device, ckpt_dir=d)
        losses = [h["loss"] for h in r["history"] if "loss" in h]
        print(f"{name}: {len(losses)} iters, misfit {losses[0]:.2f} -> "
              f"{losses[-1]:.2f}, {r['wall_s']:.1f}s, local scope: "
              f"{len(r['shard_files'])} shard files {r['spans']} "
              f"(remapped onto width {len(r['remapped']['spans'])})"
              + (f", recovered from fail-stop at iter {fail}"
                 f" {r['events']}" if fail else ""))
        results[name] = r["state"]["params"]["c"]

    stats = difference_image(data, results["baseline"],
                             results["monitor"])
    print("\n4D difference image:")
    print(f"  mean |diff| inside true anomaly:  "
          f"{stats['inside_mean_abs']:.2f} m/s")
    print(f"  mean |diff| outside true anomaly: "
          f"{stats['outside_mean_abs']:.2f} m/s")
    print(f"  (true anomaly: {stats['true_anomaly']:.0f} m/s in "
          f"{stats['anomaly_cells']} cells)")

    res, _ = overhead(replace(cfg, iterations=OVERHEAD_ITERS),
                      data["baseline"], runs=OVERHEAD_RUNS, device=device)
    base = res["without"]
    print(f"\noverhead, paper eq. 2 ({OVERHEAD_RUNS} runs x "
          f"{OVERHEAD_ITERS} iterations, saves every iteration, "
          f"on {device}):")
    print(f"  without the facade: median {base['median_s']:.3f}s; "
          f"every run within a range of {100 * res['spread']:.2f}% of it")
    for name in SAVE_CONFIGS:
        r = res[name]
        print(f"  {name}: median {r['median_s']:.3f}s, overhead "
              f"{100 * r['held_share']:.2f}% (saves held the loop; at most "
              f"{100 * r['eq2_bound']:.2f}% with the writer beside it), "
              f"eq. 2 from the medians {100 * r['eq2_raw']:.2f}% "
              f"({'resolved' if r['eq2_resolved'] else 'unresolved'}: "
              f"runs spread {100 * res['spread']:.2f}%), model bit-equal "
              f"to the unprotected run: {r['c_bit_equal']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
