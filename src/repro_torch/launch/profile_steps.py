"""Where a serve step's time goes on the card: one paged decode step over
``--max-active`` rows and one prefill padded to the pool's row, at full
width with random weights, traced with ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_steps \\
        [--arch granite-3-8b] [--seed 0]

Prints one JSON line per step: the eager call's wall time (host clock,
ended by a synchronize, as the engine runs it), the device time summed
over its kernels, their ratio as the card's idle share, and the device
time by group (the port's three kernels, matrix products, the rest) with
the largest kernels by name.  ``serve_steps`` builds the two steps; the
chip smoke test times the same callables, and ``profile_step`` also
reads its train step.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from typing import Callable, Dict

import torch

from repro_torch.configs import ALL_ARCHS
from repro_torch.models import (get_config, init_cache, init_paged_cache,
                                init_params)
from repro_torch.train import make_paged_decode_step, make_prefill_step

# decode rows' query positions: an inactive row, page boundaries, a full
# 18-page table (max_len 288 at page size 16)
LENGTHS = (0, 15, 16, 100, 200, 255, 287, 17)
GROUPS = (("rmsnorm", "rmsnorm_kernel"), ("flash_attention", "flash_fwd"),
          ("paged_attention", "paged_decode_kernel"),
          ("rmsnorm_bwd", "rmsnorm_bwd"), ("flash_attention_bwd", "flash_bwd"),
          ("ckpt_codec", "quantize_kernel"))
MATMUL_MARKS = ("gemm", "gemv", "xmma", "nvjet", "cutlass", "splitk")


def serve_steps(cfg, params, *, device, seed: int = 0, max_active: int = 8,
                page_size: int = 16, max_len: int = 288,
                prompt_len: int = 200) -> Dict[str, Callable[[], object]]:
    """The engine's two model calls at its shapes: ``decode`` advances
    ``max_active`` rows (row 0 inactive) through their page tables,
    ``prefill`` runs a ``prompt_len``-token prompt padded to ``max_len``
    against a fresh cache row."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    mpr = max_len // page_size
    pool = init_paged_cache(cfg, max_active * mpr + 1, page_size, device)
    lengths = torch.tensor([min(n, max_len - 1)
                            for n in LENGTHS[:max_active]],
                           dtype=torch.int32, device=device)
    tables = (torch.arange(max_active * mpr, dtype=torch.int32,
                           device=device).reshape(max_active, mpr) + 1)
    tables[0] = 0
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (max_active, 1),
                                     generator=gen, device=device),
             "lengths": lengths, "page_tables": tables}
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len),
                           generator=gen, device=device)
    row = init_cache(cfg, 1, max_len, device)
    decode = make_paged_decode_step(cfg)
    prefill = make_prefill_step(cfg, pad_to=max_len)
    return {"decode": lambda: decode(params, batch, pool),
            "prefill": lambda: prefill(params, {"tokens": prompt}, row)}


def _group(name: str) -> str:
    for group, mark in GROUPS:
        if mark in name:
            return group
    low = name.lower()
    return "matmul" if any(m in low for m in MATMUL_MARKS) else "other"


def _kernel_times(prof) -> Dict[str, float]:
    """Device microseconds by kernel name (device events only)."""
    out: Dict[str, float] = collections.defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.name] += evt.time_range.elapsed_us()
    return out


def profile_step(fn: Callable[[], object], calls: int = 3) -> Dict:
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / calls * 1e3
    kernels = _kernel_times(prof)
    device_ms = sum(kernels.values()) / calls / 1e3
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    groups: Dict[str, float] = collections.defaultdict(float)
    for name, us in kernels.items():
        groups[_group(name)] += us / calls / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms,
            "kernels_per_call": sum(1 for e in prof.events()
                                    if e.device_type
                                    == torch.autograd.DeviceType.CUDA)
            / calls,
            "device_ms_by_group": dict(sorted(groups.items())),
            "top_kernels_ms": {n[:96]: us / calls / 1e3 for n, us in top}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-3-8b", choices=ALL_ARCHS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-active", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_steps: needs a CUDA device", file=sys.stderr)
        return 1
    cfg = get_config(args.arch)
    params = init_params(cfg, seed=args.seed, device="cuda")
    steps = serve_steps(cfg, params, device="cuda", seed=args.seed,
                        max_active=args.max_active)
    with torch.no_grad():
        for name, fn in steps.items():
            print(json.dumps({"step": name, "arch": cfg.name,
                              "device": torch.cuda.get_device_name(0),
                              **profile_step(fn)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
