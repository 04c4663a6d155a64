"""Fault-tolerant training driver, the port's twin of the reference's
``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
        --tiny --device cpu --steps 20 --ckpt-dir /tmp/ckpt --every-n 4 \\
        --policy every_n --async-save --inject-failure 6

Wires the DeLIA stack around the BSP training loop: checkpoint policy
(Young/Daly or fixed), sync/async checkpoints (+ optional int8 codec),
termination-signal detection,
optional UDP heartbeats, straggler watchdog, the loss sentinel, and
automatic restore-on-restart.  ``--inject-failure N`` simulates a
fail-stop at step N and recovers.  The model runs on the card unless
``--device cpu``.

The reference's flags that the port does not carry yet raise
``NotImplementedError`` naming their ROADMAP item: ``--delta-checkpoint``
and ``--scrub``/``--inject-bitflip`` (item 5), ``--abft`` (item 7), the
telemetry flags (item 8), ``--data-par``/``--model-par`` > 1 (item 10).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from repro_torch.configs import ALL_ARCHS
from repro_torch.core import (Dependability, DependabilityConfig,
                              FaultInjector, SystemModel, run_with_recovery)
from repro_torch.data import make_pipeline
from repro_torch.device import resolve_device
from repro_torch.models import get_config
from repro_torch.train import init_state, make_train_step


def build(args):
    cfg = get_config(args.arch, tiny=args.tiny)
    overrides = {}
    if args.layers:
        overrides["num_layers"] = args.layers
    if args.d_model:
        overrides.update(d_model=args.d_model,
                         num_heads=max(args.d_model // 64, 1),
                         num_kv_heads=max(args.d_model // 128, 1),
                         head_dim=64, d_ff=args.d_model * 4)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def _refuse(args) -> None:
    """The reference's options this slice of the port does not carry."""
    missing = [
        (args.delta_checkpoint, "--delta-checkpoint", 5),
        (args.scrub, "--scrub", 5),
        (bool(args.inject_bitflip), "--inject-bitflip", 5),
        (args.abft, "--abft", 7),
        (bool(args.telemetry_dir), "--telemetry-dir", 8),
        (bool(args.metrics_snapshot), "--metrics-snapshot", 8),
        (args.telemetry_plane, "--telemetry-plane", 8),
        (args.proactive_checkpoint, "--proactive-checkpoint", 8),
        (args.policy == "risk_adjusted", "--policy risk_adjusted", 8),
        (args.data_par > 1, "--data-par > 1", 10),
        (args.model_par > 1, "--model-par > 1", 10),
    ]
    for used, flag, item in missing:
        if used:
            raise NotImplementedError(
                f"{flag} is not in the port yet (ROADMAP item {item})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=ALL_ARCHS)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--policy", default="young_daly",
                    choices=["young_daly", "every_n", "risk_adjusted"])
    ap.add_argument("--every-n", type=int, default=10)
    ap.add_argument("--node-mtbf-hours", type=float, default=24 * 365)
    ap.add_argument("--num-nodes", type=int, default=1)
    ap.add_argument("--async-save", action="store_true")
    ap.add_argument("--codec", default=None, choices=[None, "int8"])
    ap.add_argument("--delta-checkpoint", action="store_true")
    ap.add_argument("--delta-block", type=int, default=65536)
    ap.add_argument("--full-every", type=int, default=8)
    ap.add_argument("--heartbeat", action="store_true")
    ap.add_argument("--inject-failure", type=int, default=0,
                    help="simulate a fail-stop at this step")
    ap.add_argument("--scrub", action="store_true")
    ap.add_argument("--scrub-fraction", type=float, default=0.25)
    ap.add_argument("--sentinel", action="store_true",
                    help="tier-3 SDC: non-finite/loss-spike sentinel")
    ap.add_argument("--abft", action="store_true")
    ap.add_argument("--inject-bitflip", default="")
    ap.add_argument("--telemetry-dir", default="")
    ap.add_argument("--metrics-snapshot", default="")
    ap.add_argument("--telemetry-plane", action="store_true")
    ap.add_argument("--proactive-checkpoint", action="store_true")
    ap.add_argument("--risk-threshold", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    _refuse(args)

    device = resolve_device(args.device)
    cfg = build(args)
    data = make_pipeline(cfg, args.seq_len, args.global_batch,
                         seed=args.seed)
    dep = Dependability(DependabilityConfig(
        checkpoint_dir=args.ckpt_dir,
        policy_mode=args.policy,
        every_n=args.every_n,
        async_save=args.async_save,
        codec=args.codec,
        heartbeat=args.heartbeat,
        sentinel=args.sentinel,
        system=SystemModel(node_mtbf_seconds=args.node_mtbf_hours * 3600,
                           num_nodes=args.num_nodes),
    )).start()
    dep.register_local_state(data)

    step_fn = make_train_step(cfg, microbatches=args.microbatches,
                              total_steps=args.steps)
    state = init_state(cfg, seed=args.seed, device=device)
    template = state
    if dep.manager.latest_step() is not None:
        state, got = dep.restore_latest(like=template)
        print(f"[train] restored checkpoint step {got}")
    dep.register_global_state(template)

    injector = None
    if args.inject_failure:
        injector = FaultInjector()
        injector.schedule_failstop(args.inject_failure)

    def on_metrics(step, rec):
        if step % 10 == 0 or step == args.steps:
            print(f"[train] step {step:5d} loss={rec['loss']:.4f} "
                  f"gnorm={rec['grad_norm']:.3f} "
                  f"{rec['seconds']*1e3:.1f} ms"
                  + (" STRAGGLER" if rec["straggler"] else ""), flush=True)

    t0 = time.perf_counter()
    state, info = run_with_recovery(
        dep, step_fn, state, data, args.steps,
        fault_injector=injector, like=template, on_metrics=on_metrics)
    wall = time.perf_counter() - t0

    print(f"[train] {info['status']} in {wall:.1f}s; restarts="
          f"{info['restarts']}; checkpoints={len(dep.save_history)}; "
          f"young-daly interval={dep.policy.interval_steps()} steps")
    events = [h["event"] for h in info["history"] if "event" in h]
    if events:
        print(f"[train] failure/corruption events: {events}")
    dep.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
