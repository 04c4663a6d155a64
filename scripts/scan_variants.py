#!/usr/bin/env python3
"""Builds variants of the selective-scan kernel and times them on one
CUDA card, beside the library's own build; with ``--clock``, also the
kernel's per-warp timeline.

    python3 scripts/scan_variants.py [--seed N] [--rounds R] [--clock]

Each variant is ``src/repro_torch/csrc/selective_scan.cu`` compiled with
the library's nvcc flags and a few of its compile-time constants changed
(``-DSCAN_TILE=16`` ...) into its own shared library under
``build/scan_variants/`` (one nvcc per variant, all started together).
Each is checked against the plain version (within chip_smoke.py's
SCAN_TOL) and timed with chip_smoke.py's harness (calls captured in a
CUDA graph) at falcon-mamba-7b's prefill shapes, the variants in turns
for ``--rounds`` rounds.  Prints one JSON line per variant and shape
(ms of each round, registers and spills from ``-Xptxas -v``).

``--clock`` builds the kernel once more with ``-DSCAN_CLOCK``: every
warp stamps ``clock64`` at its start, once A and h0 have landed, and per
tile (stage refilled, tile landed, partial-sum buffer free, tile computed
and stored, the tile before folded).  One launch at the serve shape
prints the median over warps of each phase in SM clocks, beside the
launch's time in clocks at the card's maximum SM clock.

Ends with the card's ``nvidia-smi`` name and power limit.  Needs nvcc
and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.selective_scan import kernel  # noqa: E402
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    TILE, selective_scan_ref)

# name -> compile-time constants (the library's build has none)
VARIANTS = {
    "parts4": ["-DSCAN_PARTS=4"],
    "tile16": ["-DSCAN_TILE=16"],
    "stages2": ["-DSCAN_STAGES=2"],
    "ieee_expf": ["-DSCAN_IEEE_EXP"],
}
CLOCK = {"clock": ["-DSCAN_CLOCK"]}
SHAPES = ((1, 256, 8192, 16, True), (1, 200, 8192, 16, False),
          (2, 256, 8192, 16, False))
PARTS, EVENTS, BLOCKS = 8, 48, 4096      # the timeline build's layout


def build_variants(out: Path, variants):
    src = build.CSRC / "selective_scan.cu"
    jobs = {}
    for name, defs in variants.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        with open(d / "selective_scan.log", "w") as log:
            jobs[name] = (d, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, *defs, "-shared", "-I",
                 str(build.CSRC), "-o", str(d / "lib.so"), str(src)],
                stdout=log, stderr=subprocess.STDOUT))
    libs = {}
    for name, (d, proc) in jobs.items():
        if proc.wait():
            raise RuntimeError(f"{name}: nvcc failed\n"
                               + (d / "selective_scan.log").read_text())
        lib = ctypes.CDLL(str(d / "lib.so"))
        fn = lib.repro_selective_scan
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 4
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = (lib, fn, d / "selective_scan.log")
    return libs


def caller(fn):
    def call(x, dt, bm, cm, a, h0):
        B, S, Di = x.shape
        N = a.shape[-1]
        y, h = torch.empty_like(x), torch.empty_like(h0)
        tma = kernel.tma_route(x, dt, bm, cm)
        build.check(fn(x.data_ptr(), dt.data_ptr(), bm.data_ptr(),
                       cm.data_ptr(), a.data_ptr(), h0.data_ptr(),
                       y.data_ptr(), h.data_ptr(), B, S, Di, N,
                       bm.stride(0), bm.stride(1), cm.stride(0),
                       cm.stride(1), int(tma), build.stream_ptr(x.device)),
                    "selective_scan variant")
        return y, h
    return call


def usage(log):
    return {k.split("selective_scan_kernel")[-1][:12]: {
        "registers": v.get("registers"),
        "spill_stores": v.get("spill_stores")}
        for k, v in build.ptxas_usage("selective_scan", log).items()}


def timeline(lib, fn, gen):
    """Median over warps of each phase of one launch at the serve shape,
    in SM clocks."""
    B, S, Di, N = 1, 256, 8192, 16
    args = chip_smoke._scan_inputs(gen, B, S, Di, N, True)
    call = caller(fn)
    ms = chip_smoke.time_ms(lambda: call(*args))
    call(*args)
    torch.cuda.synchronize()
    buf = np.zeros(BLOCKS * PARTS * EVENTS, np.int64)
    lib.repro_selective_scan_clock.argtypes = [ctypes.c_void_p]
    build.check(lib.repro_selective_scan_clock(buf.ctypes.data), "clock")
    blocks = -(-Di // 32) * B
    ev = buf.reshape(BLOCKS, PARTS, EVENTS)[:blocks].astype(np.float64)
    nt = -(-S // TILE)

    def med(a, b):
        return float(np.median(ev[..., b] - ev[..., a]))

    def tile(a, b):
        return [med(a + 5 * k, b + 5 * k) for k in range(nt)]

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0])
    return {"timeline": f"B={B} S={S} Di={Di} N={N} h0=0",
            "launch_ms": ms, "launch_clocks": ms * 1e-3 * mhz * 1e6,
            "max_sm_mhz": mhz, "warp": med(0, EVENTS - 1),
            "a_h0_landed": med(0, 1),
            "refill": [med(1, 2)] + [med(6 + 5 * (k - 1), 2 + 5 * k)
                                     for k in range(1, nt)],
            "tile_landed": tile(2, 3), "buffer_free": tile(3, 4),
            "compute_store": tile(4, 5), "fold_before": tile(5, 6),
            "end": med(6 + 5 * (nt - 1), EVENTS - 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--clock", action="store_true",
                    help="also the timeline build's phases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_variants.py: needs a CUDA device", file=sys.stderr)
        return 1
    libs = build_variants(ROOT / "build" / "scan_variants",
                          {**VARIANTS, **(CLOCK if args.clock else {})})
    calls = {"library": (lambda *t: kernel._launch(
        *t, tma=kernel.tma_route(*t[:4]))),
        **{n: caller(fn) for n, (_, fn, _) in libs.items()
           if n in VARIANTS}}
    logs = {"library": build.build_dir() / "selective_scan.log",
            **{n: log for n, (_, _, log) in libs.items()}}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    for B, S, Di, N, h0_zero in SHAPES:
        inputs = chip_smoke._scan_inputs(gen, B, S, Di, N, h0_zero)
        want = selective_scan_ref(*inputs)
        rows = {}
        for name, call in calls.items():
            got = call(*inputs)
            err = max(chip_smoke.check_close(f"{name} {w}", g, r,
                                             chip_smoke.SCAN_TOL)
                      for w, g, r in zip(("y", "h"), got, want))
            rows[name] = {"variant": name, "flags": VARIANTS.get(name, []),
                          "shape": f"B={B} S={S} Di={Di} N={N} h0="
                                   + ("0" if h0_zero else "random"),
                          "max_abs_err": err, "ms": [],
                          "ptxas": usage(logs[name])}
        for _ in range(args.rounds):
            for name, call in calls.items():
                rows[name]["ms"].append(chip_smoke.time_ms(
                    lambda: call(*inputs)))
        for row in rows.values():
            print(json.dumps(row), flush=True)
    if args.clock:
        lib, fn, _ = libs["clock"]
        print(json.dumps(timeline(lib, fn, gen)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
