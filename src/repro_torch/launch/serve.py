"""Serving driver: thin CLI over ``repro_torch.serve.ServeEngine`` —
continuous batching over a block-paged KV cache with prefix sharing (the
default wherever the stack can page; ``--legacy-pool`` forces the slot
pool of contiguous rows, a Mamba stack's only pool), N replicas with
heartbeat failover, warm standbys restored from a parameter checkpoint,
decode-path SDC sentinel.  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
        --requests 8 --prompt-len 128 --gen 32 \\
        --replicas 2 --slots 4 --max-active 8 --fault-tolerant \\
        --kill-replica-at 5

    # the tiny config on the CPU (plain PyTorch versions of the kernels)
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --device cpu

    # the slot pool on an attention stack; the only replica killed at
    # step 2 and a warm standby restored from a checkpoint in its place
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --device cpu \
        --legacy-pool --standbys 1 --kill-replica-at 2

    # Mamba-1 through the slot pool (--slots rows a replica)
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch falcon-mamba-7b --tiny --device cpu --replicas 2 \
        --fault-tolerant --kill-replica-at 3

    # the telemetry plane: anomaly detectors over the engine's per-replica
    # step timings pre-drain a replica whose host risk crosses
    # --risk-threshold; --telemetry-dir records the bundle
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --device cpu \
        --replicas 2 --pre-drain --telemetry-dir /tmp/serve_telemetry
"""
from __future__ import annotations

import argparse
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np

from repro_torch.configs import ALL_ARCHS
from repro_torch.core import CheckpointManager, FaultInjector
from repro_torch.models import get_config, init_params
from repro_torch.obs import AnomalyEngine, Observability
from repro_torch.serve import ServeEngine, make_standby_source, pctl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=ALL_ARCHS)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the prompts")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--replicas", type=int, default=1,
                    help="model replicas in the serving pool")
    ap.add_argument("--slots", type=int, default=4,
                    help="KV-cache slots per replica (max in-flight "
                    "requests each); the paged pool's default size is the "
                    "memory of this many max-length rows, repaged")
    pool = ap.add_mutually_exclusive_group()
    pool.add_argument("--paged", action="store_true", default=None,
                      dest="paged",
                      help="block-paged KV cache with prefix sharing; the "
                      "default wherever the model supports it")
    pool.add_argument("--legacy-pool", action="store_false", dest="paged",
                      help="force the slot pool of contiguous rows")
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per KV page (default 16)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pages in each replica's pool (default: --slots "
                    "max-length rows' worth)")
    ap.add_argument("--max-active", type=int, default=None,
                    help="decode rows per replica (default: --slots)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable refcounted prefix sharing between "
                    "requests")
    ap.set_defaults(paged=None)         # auto: paged where supported
    ap.add_argument("--fault-tolerant", action="store_true",
                    help="heartbeat monitoring + decode sentinel + "
                    "failover (re-execute drained requests on survivors)")
    ap.add_argument("--standbys", type=int, default=0,
                    help="warm standbys restored from a params checkpoint "
                    "on failure (implies --fault-tolerant)")
    ap.add_argument("--kill-replica-at", type=int, default=-1,
                    help="inject a replica kill at this engine step "
                    "(drives the failover path end to end)")
    ap.add_argument("--telemetry-dir", default="",
                    help="record the run's telemetry bundle here "
                         "(events.jsonl + trace.json + metrics)")
    ap.add_argument("--metrics-snapshot", default="",
                    help="write a JSON metrics snapshot to this path at "
                         "the end of the run")
    ap.add_argument("--pre-drain", action="store_true",
                    help="telemetry plane: run the anomaly detectors over "
                         "the engine's event stream and pre-drain a "
                         "replica whose host risk crosses "
                         "--risk-threshold")
    ap.add_argument("--risk-threshold", type=float, default=0.8)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, tiny=args.tiny)
    if not cfg.has_decode:
        print(f"{args.arch} is encoder-only; no decode loop")
        return 1
    if cfg.embedding_inputs:
        print(f"{args.arch} takes embedding inputs; the engine serves "
              "token prompts")
        return 1
    params = init_params(cfg, seed=args.seed, device=args.device)
    injector = None
    if args.kill_replica_at >= 0:
        injector = FaultInjector()
        injector.schedule_replica_kill(args.kill_replica_at,
                                       replica_id=args.replicas - 1)
    obs = None
    if args.telemetry_dir or args.metrics_snapshot or args.pre_drain:
        obs = Observability(
            jsonl_path=(os.path.join(args.telemetry_dir, "events.jsonl")
                        if args.telemetry_dir else None))
    risk_source = None
    if args.pre_drain:
        anomaly = AnomalyEngine()
        anomaly.attach(obs.bus)
        risk_source = anomaly.risk_scores

    paged_kw = {}
    if args.page_size is not None:
        paged_kw["page_size"] = args.page_size
    engine = ServeEngine(cfg, params, device=args.device,
                         num_replicas=args.replicas,
                         slots_per_replica=args.slots,
                         max_len=args.prompt_len + args.gen,
                         fault_tolerant=(args.fault_tolerant
                                         or args.standbys > 0),
                         fault_injector=injector, obs=obs,
                         risk_source=risk_source,
                         pre_drain_threshold=args.risk_threshold,
                         paged=args.paged, num_pages=args.num_pages,
                         max_active=args.max_active,
                         prefix_cache=not args.no_prefix_cache, **paged_kw)
    ckpt_dir = manager = None
    try:
        if args.standbys > 0:
            # warm-standby params come back through restore_latest — the
            # walk-back-past-corruption path training recovery uses
            ckpt_dir = tempfile.mkdtemp(prefix="serve_standby_")
            manager = CheckpointManager(ckpt_dir, fsync="none")
            manager.save(0, {"params": params})
            for _ in range(args.standbys):
                engine.add_standby(make_standby_source(manager, params))
        return _serve_requests(args, cfg, engine, obs)
    finally:
        engine.shutdown()
        if manager is not None:
            manager.close()
        if ckpt_dir is not None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


def _serve_requests(args, cfg, engine, obs) -> int:
    rng = np.random.default_rng(args.seed + 100)
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=args.prompt_len)
        engine.submit([int(t) for t in prompt], args.gen)

    t0 = time.perf_counter()
    results = engine.run()
    wall = time.perf_counter() - t0

    lat = engine.request_latencies()
    ttft = sorted(t for _, t, _ in lat)
    total = sorted(t for _, _, t in lat)
    done_tokens = sum(len(v) for v in results.values())
    fns = engine.fns
    rows = (f"{fns.max_active} paged rows ({fns.num_pages} x "
            f"{fns.page_size}-token pages)" if engine.paged
            else f"{fns.num_slots} slots")
    print(f"served {len(results)}/{args.requests} requests "
          f"({done_tokens} tokens) in {wall:.2f}s on {args.replicas} "
          f"replica(s) x {rows} on {engine.device} -> "
          f"{done_tokens / wall:.0f} tok/s")
    reps = engine.router.replicas.values()
    if engine.paged:
        cons = engine.page_conservation()
        hits = sum(r.pool.prefix_hits for r in reps)
        misses = sum(r.pool.prefix_misses for r in reps)
        print(f"paged KV: prefix hits {hits}/{hits + misses}, "
              f"{cons['pages_free']}/{cons['pages_total']} pages free, "
              f"refcounts {'ok' if cons['refs_ok'] else 'DRIFTED'}")
    else:
        free = sum(r.pool.free_count for r in reps)
        print(f"slot pool: {free}/{fns.num_slots * len(reps)} slots free")
    if total:
        print(f"latency  p50={statistics.median(total) * 1e3:.0f}ms "
              f"p99={pctl(total, 0.99) * 1e3:.0f}ms "
              f"ttft p50={statistics.median(ttft) * 1e3:.0f}ms")
    for ev in engine.events:
        print(f"event step={ev['step']}: {ev['event']} "
              + " ".join(f"{k}={v}" for k, v in ev.items()
                         if k not in ("t", "step", "event")))
    retried = len(engine.scheduler.retried_rids)
    if retried:
        print(f"failover: {retried} request(s) drained and re-executed, "
              f"{len(engine.scheduler.failed_rids)} dropped")
    if obs is not None:
        summary = obs.timeline().summary()
        mttr = summary["mttr_s"]
        mttr_txt = f"MTTR={mttr:.3f}s, " if mttr is not None else ""
        print(f"telemetry: {summary['incidents']} incidents, "
              f"{mttr_txt}availability={summary['availability']:.4f} "
              f"over {summary['span_s']:.1f}s observed")
        if args.telemetry_dir:
            paths = obs.dump(args.telemetry_dir)
            print(f"telemetry bundle: {sorted(paths.values())}")
        if args.metrics_snapshot:
            obs.registry.to_json(args.metrics_snapshot)
            print(f"metrics snapshot: {args.metrics_snapshot}")
        obs.close()
    return 0 if len(results) == args.requests else 1


if __name__ == "__main__":
    sys.exit(main())
