"""Fault-tolerant training driver, the port's twin of the reference's
``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
        --tiny --device cpu --steps 20 --ckpt-dir /tmp/ckpt --every-n 4 \\
        --policy every_n --async-save --inject-failure 6

Wires the DeLIA stack around the BSP training loop: checkpoint policy
(Young/Daly or fixed), sync/async checkpoints (+ optional int8 codec,
delta saves of the blocks that changed), termination-signal detection,
optional UDP heartbeats, straggler watchdog, and automatic
restore-on-restart.  ``--inject-failure N`` simulates a fail-stop at step
N and recovers.  The model runs on the card unless ``--device cpu``.
Every registered family trains, on one rank or on a rank mesh
(``--data-par``/``--model-par``, below): attention stacks, Mamba-1
stacks (``--arch falcon-mamba-7b``: the selective scan and its backward
kernel on the card), RG-LRU hybrids, embedding-input stacks (qwen2-vl's
M-RoPE positions, hubert's frame targets) and padded q heads:

    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \
        --tiny --device cpu --steps 12 --seq-len 32 --global-batch 4 \
        --microbatches 2 --policy every_n --every-n 4 --async-save \
        --inject-failure 6 --ckpt-dir /tmp/ckpt_ssm
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch recurrentgemma-2b --tiny --device cpu --steps 12 \
        --seq-len 32 --global-batch 4 --microbatches 2 --policy every_n \
        --every-n 4 --inject-failure 6 --ckpt-dir /tmp/ckpt_rec

SDC guard: ``--scrub``/``--sentinel`` turn on the tier-2/3 detectors,
``--abft`` routes the projection matmuls through the checksummed kernel
(tier 1), and ``--inject-bitflip STEP:LEAF:BIT`` flips one state bit
mid-run to watch detection and rollback:

    PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \
        --steps 12 --policy every_n --every-n 2 --delta-checkpoint \
        --full-every 3 --scrub --scrub-fraction 1.0 \
        --inject-bitflip 5:params.embed.tok:30 --ckpt-dir /tmp/ckpt

Telemetry (docs/observability.md): ``--telemetry-dir`` records the run's
bundle (events.jsonl, trace.json, metrics.json, metrics.prom),
``--metrics-snapshot`` a JSON metrics snapshot; ``--telemetry-plane``
runs the anomaly detectors over the event stream, and
``--proactive-checkpoint`` forces a save when a host's risk crosses
``--risk-threshold`` (with ``--policy risk_adjusted`` the risk also
tightens the Young/Daly interval):

    PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \
        --steps 12 --inject-failure 8 --policy risk_adjusted \
        --proactive-checkpoint --telemetry-dir /tmp/telemetry \
        --metrics-snapshot /tmp/metrics.json --ckpt-dir /tmp/ckpt_obs

``--data-par D --model-par M`` trains on a D x M rank mesh (one process
a rank, ``sharding/launch.py``; every rank on the one card, or on the
CPU with ``--device cpu``): each rank holds its shards of the state and
computes its batch rows, heads and ``d_ff`` columns
(``train/mesh_step.py``); the saves are sharded and every rank restores
its own shards.  Rank 0 prints the run's lines:

    PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \
        --data-par 2 --model-par 2 --steps 12 --policy every_n \
        --every-n 4 --inject-failure 6 --ckpt-dir /tmp/ckpt_mesh
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from repro_torch.configs import ALL_ARCHS
from repro_torch.core import (Dependability, DependabilityConfig,
                              FaultInjector, SystemModel, run_with_recovery)
from repro_torch.data import make_pipeline
from repro_torch.device import resolve_device
from repro_torch.models import get_config
from repro_torch.obs import AnomalyEngine, Observability, make_proactive_hook
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


def parse(argv=None):
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
    ap.add_argument("--delta-checkpoint", action="store_true",
                    help="incremental saves: write only blocks whose "
                         "on-device hash changed since the last checkpoint")
    ap.add_argument("--delta-block", type=int, default=65536,
                    help="elements per delta block (multiple of 256)")
    ap.add_argument("--full-every", type=int, default=8,
                    help="force a full save every N checkpoints "
                         "(bounds the delta reference-chain depth)")
    ap.add_argument("--heartbeat", action="store_true")
    ap.add_argument("--inject-failure", type=int, default=0,
                    help="simulate a fail-stop at this step")
    ap.add_argument("--scrub", action="store_true",
                    help="tier-2 SDC: rotating state-checksum scrubber")
    ap.add_argument("--scrub-fraction", type=float, default=0.25)
    ap.add_argument("--sentinel", action="store_true",
                    help="tier-3 SDC: non-finite/loss-spike sentinel")
    ap.add_argument("--abft", action="store_true",
                    help="tier-1 SDC: checksummed projection matmuls")
    ap.add_argument("--inject-bitflip", default="",
                    help="STEP:LEAF:BIT, e.g. 50:params.embed.tok:30 — "
                         "flip one state bit mid-run (SDC fault model)")
    ap.add_argument("--telemetry-dir", default="",
                    help="record the run's telemetry bundle here "
                         "(events.jsonl + trace.json + metrics)")
    ap.add_argument("--metrics-snapshot", default="",
                    help="write a JSON metrics snapshot to this path at "
                         "the end of the run")
    ap.add_argument("--telemetry-plane", action="store_true",
                    help="run the in-process telemetry plane: anomaly "
                         "detectors over the event stream, per-host risk "
                         "scores")
    ap.add_argument("--proactive-checkpoint", action="store_true",
                    help="force a checkpoint when a precursor pushes any "
                         "host's risk past --risk-threshold (implies "
                         "--telemetry-plane)")
    ap.add_argument("--risk-threshold", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    ranks = args.data_par * args.model_par
    if ranks > 1:
        from repro_torch.sharding.launch import spawn

        if args.abft:
            raise ValueError("--abft runs on one rank (the checksummed "
                             "projections have no mesh layout)")
        device = str(resolve_device(args.device))
        spawn(_rank_entry, ranks, args=(argv,), device=device,
              run_dir=os.path.join(args.ckpt_dir, ".ranks"),
              join_timeout=24 * 3600.0)
        return 0
    return run(args)


def _rank_entry(world, argv) -> int:
    return run(parse(argv), world)


def run(args, world=None) -> int:
    """One rank's run (``world`` None: the whole run on one rank)."""
    device = resolve_device(args.device if world is None
                            else str(world.device))
    rank0 = world is None or world.rank == 0
    cfg = build(args)
    data = make_pipeline(cfg, args.seq_len, args.global_batch,
                         seed=args.seed)
    dep = Dependability(DependabilityConfig(
        checkpoint_dir=args.ckpt_dir,
        policy_mode=args.policy,
        every_n=args.every_n,
        async_save=args.async_save,
        codec=args.codec,
        delta_checkpoint=args.delta_checkpoint,
        delta_block=args.delta_block,
        full_every=args.full_every,
        heartbeat=args.heartbeat and rank0,
        monitor_hosts=1,
        scrub=args.scrub,
        scrub_fraction=args.scrub_fraction,
        sentinel=args.sentinel,
        system=SystemModel(node_mtbf_seconds=args.node_mtbf_hours * 3600,
                           num_nodes=args.num_nodes),
    )).start()
    dep.register_local_state(data)
    mesh = shardings = None
    if world is not None:
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.train.mesh_step import mesh_combos

        if rank0:
            world.publish("train/pid/0", str(os.getpid()))
        dep.manager.set_hosts(world.rank, world.size,
                              owner_pid=int(world.fetch("train/pid/0")))
        dep.world = world
        mesh = make_host_mesh(args.data_par, args.model_par, rank=world.rank,
                              device=device)
        mesh.init_groups(mesh_combos(mesh))

    obs = None
    want_plane = (args.telemetry_plane or args.proactive_checkpoint) and rank0
    if rank0 and (args.telemetry_dir or args.metrics_snapshot or want_plane):
        obs = Observability(
            jsonl_path=(os.path.join(args.telemetry_dir, "events.jsonl")
                        if args.telemetry_dir else None))
        dep.attach_obs(obs)

    proactive = None
    if want_plane:
        anomaly = AnomalyEngine()
        anomaly.attach(obs.bus)
        if args.proactive_checkpoint:
            proactive = make_proactive_hook(
                anomaly.risk_scores, threshold=args.risk_threshold,
                policy=(dep.policy if args.policy == "risk_adjusted"
                        else None))
        elif args.policy == "risk_adjusted":
            # no forced saves: risk still tightens the Young/Daly
            # interval through the policy
            def proactive(step, _a=anomaly, _p=dep.policy):
                _p.observe_risk(max(_a.risk_scores().values(), default=0.0))
                return None

    if mesh is None:
        step_fn = make_train_step(cfg, microbatches=args.microbatches,
                                  total_steps=args.steps,
                                  impl=("abft" if args.abft else None))
        state = init_state(cfg, seed=args.seed, device=device)
        template = state
    else:
        from repro_torch.train.mesh_step import (init_sharded_state,
                                                 make_mesh_train_step,
                                                 state_shardings)

        shardings = state_shardings(cfg, mesh)
        template = init_state(cfg, seed=args.seed, device="meta")
        step_fn = make_mesh_train_step(cfg, mesh, shardings, template,
                                       microbatches=args.microbatches,
                                       total_steps=args.steps)
        state = init_sharded_state(cfg, shardings, seed=args.seed,
                                   device=device, world=world)
    if dep.manager.latest_step() is not None:
        state, got = dep.restore_latest(like=template, shardings=shardings)
        if rank0:
            print(f"[train] restored checkpoint step {got}")
    dep.register_global_state(template, shardings)

    injector = None
    if args.inject_failure:
        injector = FaultInjector()
        injector.schedule_failstop(args.inject_failure)
    if args.inject_bitflip:
        step_s, leaf, bit_s = args.inject_bitflip.split(":")
        injector = injector or FaultInjector()
        injector.schedule_bitflip(int(step_s), leaf, int(bit_s))

    def on_metrics(step, rec):
        if rank0 and (step % 10 == 0 or step == args.steps):
            print(f"[train] step {step:5d} loss={rec['loss']:.4f} "
                  f"gnorm={rec['grad_norm']:.3f} "
                  f"{rec['seconds']*1e3:.1f} ms"
                  + (" STRAGGLER" if rec["straggler"] else ""), flush=True)

    t0 = time.perf_counter()
    state, info = run_with_recovery(
        dep, step_fn, state, data, args.steps,
        fault_injector=injector, like=template, on_metrics=on_metrics,
        proactive=proactive)
    wall = time.perf_counter() - t0
    if not rank0:
        dep.stop()
        return 0

    n_saves = len(dep.save_history)
    n_delta = sum(1 for s in dep.save_history if s.kind == "delta")
    delta_info = (f" ({n_saves - n_delta} full + {n_delta} delta)"
                  if args.delta_checkpoint else "")
    where = (f" on {args.data_par}x{args.model_par} ranks"
             if world is not None else "")
    print(f"[train] {info['status']} in {wall:.1f}s{where}; restarts="
          f"{info['restarts']}; checkpoints={n_saves}{delta_info}; "
          f"young-daly interval={dep.policy.interval_steps()} steps")
    events = [h["event"] for h in info["history"] if "event" in h]
    if events:
        print(f"[train] failure/corruption events: {events}")
    if obs is not None:
        summary = obs.timeline().summary()
        mttr = summary["mttr_s"]
        mttr_txt = f"MTTR={mttr:.3f}s, " if mttr is not None else ""
        print(f"[train] telemetry: {summary['incidents']} incidents, "
              f"{mttr_txt}availability={summary['availability']:.4f} "
              f"over {summary['span_s']:.1f}s observed")
        if args.telemetry_dir:
            paths = obs.dump(args.telemetry_dir)
            print(f"[train] telemetry bundle: {sorted(paths.values())}")
        if args.metrics_snapshot:
            obs.registry.to_json(args.metrics_snapshot)
            print(f"[train] metrics snapshot: {args.metrics_snapshot}")
        obs.close()
    dep.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
