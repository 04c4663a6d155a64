#!/usr/bin/env python3
"""Builds variants of the selective-scan kernel and times them on one
CUDA card, beside the library's own build; with ``--clock``, also the
kernel's per-warp timeline.

    python3 scripts/scan_variants.py [--seed N] [--rounds R] [--clock]
    python3 scripts/scan_variants.py --bwd [--seed N] [--rounds R]

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

``--bwd`` does the same for the scan's backward
(``csrc/selective_scan_bwd.cu``, ``-DSCAN_BWD_TILE=8`` ...): each variant
held to the plain reverse scan (within chip_smoke.py's float32 GRAD_TOL
of each gradient's largest magnitude) and to itself (two launches
bit-equal), then timed in turns at one train-ssm microbatch and at a
ragged shape on the 4-byte route.  ``--parent DIR`` adds the backward
of another checkout (``DIR/src/repro_torch/csrc/selective_scan_bwd.cu``,
built with its own headers and called through its own entry point) to
the same checks and turns (parent, this tree, ..., this tree, parent).  ``--bwd --clock`` adds the timeline
build (``-DSCAN_BWD_CLOCK``): lane 0 of every warp sums the SM clocks of
each phase (pass 1, its waits for tiles, pass 2's recompute and reverse
steps, the folds, the waits on the other warps); one launch at the
train-ssm shape prints each phase's median over warps beside the
launch's clocks, and the SASS census of the library's backward kernels
(instructions by opcode, from ``cuobjdump -sass``).

Ends with the card's ``nvidia-smi`` name and power limit.  Needs nvcc
and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
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
    TILE, selective_scan_bwd_ref, selective_scan_ref)

# name -> compile-time constants (the library's build has none)
VARIANTS = {
    "parts4": ["-DSCAN_PARTS=4"],
    "tile16": ["-DSCAN_TILE=16"],
    "stages2": ["-DSCAN_STAGES=2"],
    "ieee_expf": ["-DSCAN_IEEE_EXP"],
}
CLOCK = {"clock": ["-DSCAN_CLOCK"]}
# the backward's: name -> compile-time constants
BWD_VARIANTS = {
    # the parent's shape of work: 8 warps of 2 states, 16-step tiles, the
    # decays kept in registers
    "parts8_tile16_keep_e": ["-DSCAN_BWD_PARTS=8", "-DSCAN_BWD_TILE=16",
                             "-DSCAN_BWD_KEEP_E"],
    "keep_e": ["-DSCAN_BWD_KEEP_E"],
    "stages4_bufs2": ["-DSCAN_BWD_STAGES=4", "-DSCAN_BWD_BUFS=2"],
}
# (B, S, Di, N, carried): a train-ssm microbatch (B and C column slices
# of one tensor, as the layer passes them), a ragged S and Di with h0
# and dh_last (the 4-byte route)
BWD_SHAPES = ((2, 2048, 8192, 16, False), (1, 1000, 8190, 16, True))
SHAPES = ((1, 256, 8192, 16, True), (1, 200, 8192, 16, False),
          (2, 256, 8192, 16, False))
PARTS, EVENTS, BLOCKS = 8, 48, 4096      # the timeline build's layout


def build_variants(out: Path, variants, stem: str = "selective_scan",
                   csrc: dict = None):
    """Each variant of ``csrc/<stem>.cu`` into its own library (from the
    directory ``csrc[name]`` where given); returns name -> (library, its
    entry point, build log)."""
    jobs = {}
    for name, defs in variants.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        root = (csrc or {}).get(name, build.CSRC)
        with open(d / f"{stem}.log", "w") as log:
            jobs[name] = (d, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, *defs, "-shared", "-I",
                 str(root), "-o", str(d / "lib.so"),
                 str(root / f"{stem}.cu")],
                stdout=log, stderr=subprocess.STDOUT))
    libs = {}
    for name, (d, proc) in jobs.items():
        if proc.wait():
            raise RuntimeError(f"{name}: nvcc failed\n"
                               + (d / f"{stem}.log").read_text())
        lib = ctypes.CDLL(str(d / "lib.so"))
        fn = getattr(lib, f"repro_{stem}")
        if stem == "selective_scan":
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                           + [ctypes.c_longlong] * 4
                           + [ctypes.c_int, ctypes.c_void_p])
        else:
            # a parent's entry point may take no route argument
            route = [] if name == "parent" else [ctypes.c_int]
            fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                           + [ctypes.c_longlong] * 4 + route
                           + [ctypes.c_void_p])
            lib.repro_selective_scan_bwd_scratch.argtypes = [ctypes.c_int] * 4
            lib.repro_selective_scan_bwd_scratch.restype = ctypes.c_longlong
        fn.restype = ctypes.c_int
        libs[name] = (lib, fn, d / f"{stem}.log")
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


def bwd_caller(lib, fn, route: bool = True):
    """The backward entry point of a variant's library as a function of
    the operands (``route``: its entry point takes the ring's route)."""
    def call(x, dt, bm, cm, a, h0, dy, dh=None):
        B, S, Di = x.shape
        N = a.shape[-1]
        out = [torch.empty_like(x), torch.empty_like(x),
               torch.empty((B, S, N), device=x.device),
               torch.empty((B, S, N), device=x.device), torch.empty_like(a),
               torch.empty_like(h0)]
        scratch = torch.empty(lib.repro_selective_scan_bwd_scratch(
            B, S, Di, N), device=x.device)
        tma = [int(kernel.bwd_tma_route(x, dt, bm, cm, dy))] if route else []
        build.check(fn(*(t.data_ptr() for t in (x, dt, bm, cm, a, h0, dy)),
                       None if dh is None else dh.data_ptr(),
                       *(t.data_ptr() for t in out), scratch.data_ptr(),
                       B, S, Di, N, bm.stride(0), bm.stride(1),
                       cm.stride(0), cm.stride(1), *tma,
                       build.stream_ptr(x.device)),
                    "selective_scan_bwd variant")
        return tuple(out)
    return call


def bwd_inputs(gen, B, S, Di, N, carried):
    """chip_smoke.py's backward draws: B and C column slices of one
    tensor, dy ~ N(0, 1), and with ``carried`` a random h0 and dh_last."""
    x, dt, bm, cm, a, h0 = chip_smoke._scan_inputs(gen, B, S, Di, N,
                                                   not carried)
    bcd = torch.cat([bm, cm], dim=-1)
    dy = torch.randn((B, S, Di), generator=gen, device="cuda")
    dh = (torch.randn((B, Di, N), generator=gen, device="cuda")
          if carried else None)
    return (x, dt, bcd[..., :N], bcd[..., N:], a, h0, dy, dh)


BWD_PHASES = ("total", "pass1", "pass1_wait_tile", "refill_wait", "pass2",
              "pass2_wait_tile", "recompute", "reverse", "wait_buffer_free",
              "fold_rows", "fold_run", "wait_parts_stored", "init")


def bwd_timeline(lib, fn, gen) -> dict:
    """Median over warps of each phase's SM clocks in one launch at the
    train-ssm shape (the timeline build)."""
    B, S, Di, N = BWD_SHAPES[0][:4]
    args = bwd_inputs(gen, B, S, Di, N, False)
    call = bwd_caller(lib, fn)
    ms = chip_smoke.time_ms(lambda: call(*args), iters=5, reps=5)
    call(*args)
    torch.cuda.synchronize()
    events = 16
    buf = np.zeros(4096 * 8 * events, np.int64)
    lib.repro_selective_scan_bwd_clock.argtypes = [ctypes.c_void_p]
    build.check(lib.repro_selective_scan_bwd_clock(buf.ctypes.data), "clock")
    blocks = -(-Di // 32) * B
    warps = 4                                 # the default build's parts
    ev = buf.reshape(4096, 8, events)[:blocks, :warps].reshape(-1, events)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0])
    return {"timeline": f"B={B} S={S} Di={Di} N={N} h0=0", "launch_ms": ms,
            "launch_clocks": ms * 1e-3 * mhz * 1e6, "max_sm_mhz": mhz,
            **{name: float(np.median(ev[:, i]))
               for i, name in enumerate(BWD_PHASES)}}


def sass_census(lib_path: Path, mark: str) -> dict:
    """Instructions by opcode of each kernel whose name holds ``mark``
    in the library's SASS."""
    text = subprocess.run(
        [str(Path(build._nvcc()).parent / "cuobjdump"), "-sass",
         str(lib_path)], capture_output=True, text=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = (out.setdefault(m.group(1)[-60:], {})
                   if mark in m.group(1) else None)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if cur is not None and m:
            op = m.group(1).split(".")[0]
            cur[op] = cur.get(op, 0) + 1
    return {name: dict(sorted(ops.items(), key=lambda kv: -kv[1]),
                       total=sum(ops.values()))
            for name, ops in out.items()}


def bwd_main(rounds: int, gen, clock: bool = False,
             parent: Path = None) -> None:
    extra = {"clock": ["-DSCAN_BWD_CLOCK"]} if clock else {}
    if parent is not None:
        extra["parent"] = []
    libs = build_variants(
        ROOT / "build" / "scan_variants", {**BWD_VARIANTS, **extra},
        "selective_scan_bwd",
        {"parent": parent / "src" / "repro_torch" / "csrc"} if parent
        else None)
    clock_lib = libs.pop("clock", None)
    calls = {"library": lambda *t: kernel._bwd_launch(
        *t, tma=kernel.bwd_tma_route(*t[:4], t[6])),
        **{n: bwd_caller(lib, fn, n != "parent")
           for n, (lib, fn, _) in libs.items()}}
    if parent is not None:
        calls = {"parent": calls.pop("parent"), **calls}
    logs = {"library": build.build_dir() / "selective_scan_bwd.log",
            **{n: log for n, (_, _, log) in libs.items()}}
    names = ("dx", "ddt", "dB", "dC", "dA", "dh0")
    tol = chip_smoke.GRAD_TOL[torch.float32]
    # each variant against the plain reverse scan and itself, at a small
    # shape the plain version computes in seconds
    args = bwd_inputs(gen, 2, 256, 8192, 16, True)
    want = selective_scan_bwd_ref(*args)
    checks = {}
    for name, call in calls.items():
        got, again = call(*args), call(*args)
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            raise AssertionError(f"{name}: two launches differ")
        checks[name] = max(chip_smoke.check_grad(f"{name} {n}", g, w, tol)
                           for n, g, w in zip(names, got, want))
    del args, want
    for B, S, Di, N, carried in BWD_SHAPES:
        args = bwd_inputs(gen, B, S, Di, N, carried)
        rows = {name: {"variant": name, "flags": BWD_VARIANTS.get(name, []),
                       "shape": f"B={B} S={S} Di={Di} N={N}" + (
                           " h0, dh_last" if carried else " h0 = 0"),
                       "route": ("tma" if kernel.bwd_tma_route(
                           *args[:4], args[6]) else "4-byte"),
                       "max_abs_err_b2_s256": checks[name], "ms": [],
                       "ptxas": {k.split("selective_scan_bwd_")[-1][:24]: v
                                 for k, v in build.ptxas_usage(
                                     "selective_scan_bwd", logs[name])
                                 .items()}}
                for name in calls}
        for r in range(rounds):
            # in turns, each round in the other order: parent, this tree,
            # ..., this tree, parent
            names = list(calls) if r % 2 == 0 else list(calls)[::-1]
            for name in names:
                rows[name]["ms"].append(chip_smoke.time_ms(
                    lambda: calls[name](*args), iters=5, reps=5))
        for row in rows.values():
            print(json.dumps(row), flush=True)
        del args
        torch.cuda.empty_cache()
    if clock_lib is not None:
        print(json.dumps(bwd_timeline(clock_lib[0], clock_lib[1], gen)),
              flush=True)
        census = sass_census(build.build_dir() / build.LIB_NAME,
                             "selective_scan_bwd")
        print(json.dumps({"sass": census}), flush=True)


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
    ap.add_argument("--bwd", action="store_true",
                    help="the backward's variants instead of the forward's")
    ap.add_argument("--parent", type=Path, default=None,
                    help="with --bwd: a checkout whose backward is timed "
                         "in the same turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_variants.py: needs a CUDA device", file=sys.stderr)
        return 1
    if args.bwd:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed)
        bwd_main(args.rounds, gen, args.clock, args.parent)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        return 0
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
