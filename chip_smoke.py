#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Runs from the root of a checkout; imports neither ``jax`` nor ``repro``.
Every phase prints one JSON line and raises on a fault, so any failure
ends the run with a non-zero exit code and no result line:

1. ``card``    — the device, and ``nvidia-smi``'s name and power limit;
2. ``build``   — compiles the CUDA kernels from ``src/repro_torch/csrc``
                 (``kernels/build.py``: one ``nvcc`` per source, in
                 parallel) and reports the seconds it took;
3. ``kernel``  — each hand-written kernel against its plain PyTorch version
                 on the same inputs on the card, at the serving path's
                 shapes: max error and tolerance, kernel / plain / library
                 times (calls captured in a CUDA graph, timed with CUDA
                 events) and the card's lower bound;
4. ``tiny``    — tiny granite served in float32 through ``ServeEngine`` on
                 the card (kernels) and on the CPU (plain versions): the
                 greedy streams must agree token for token;
5. ``serve``   — granite-3-8b at full width (40 layers, random weights
                 from ``--seed``) on 2 replicas sharing one set of weights:
                 8 requests with shared prefixes and an exact repeat, once
                 without faults and once with replica 1 killed at engine
                 step 5.  Every launch counter is zeroed just before each
                 run and must match the path afterwards; both runs must
                 serve every request, the streams must be identical, the
                 page accounting must hold and the decode sentinel must
                 stay quiet;
6. ``steps``   — one decode step and one prefill at the serve phase's
                 shapes, eager (as the engine runs them) against their
                 device time alone (captured in a CUDA graph).

Then the kernels summary (one JSON object), the ``nvidia-smi`` line, and
the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks (dense, NVIDIA data sheets): bytes/s, bf16 FLOP/s.
PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100 NVL": (3.9e12, 835e12),
         "H100 SXM": (3.35e12, 989e12)}
BF16_TOL = 2e-2                  # tests/test_kernels.py's bf16 tolerance
PAGE_SIZE = 16
PROMPT_LENS = (128, 200, 256)
GEN = 32
MAX_LEN = max(PROMPT_LENS) + GEN                     # 288 = 18 pages
MAX_ACTIVE = 8
KILL_STEP = 5

# replaced TPU kernels (file:line of the function that reaches pallas_call)
KERNELS = {
    "rmsnorm": ("csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:26"),
    "flash_attention": ("csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:77"),
    "paged_attention": ("csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/kernel.py:84"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peaks(name: str):
    for key, val in PEAKS.items():
        if key.split()[1] in name:
            return key, val
    return "H100 SXM", PEAKS["H100 SXM"]


def time_ms(fn, iters: int = 20, reps: int = 7) -> float:
    """Device time of one ``fn`` call.  ``iters`` calls are captured in one
    CUDA graph, so the host's per-call cost (argument checks, the ctypes
    call, PyTorch's dispatch) stays out of the number; the graph is
    replayed ``reps`` times, each between two CUDA events, and the median
    replay is reported.  Inputs stay in the L2 cache from one call to the
    next."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                          # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events) / iters


def check_close(name: str, got, want, tol: float) -> float:
    """Raises unless |got - want| <= tol + tol * |want| everywhere (the
    allclose of tests/test_kernels.py); returns the max abs error."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    diff = (got - want).abs()
    if (diff > tol + tol * want.abs()).any():
        raise AssertionError(f"{name}: max abs error {diff.max().item():.3g}"
                             f" beyond tolerance {tol}")
    return diff.max().item()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    peak_name, (bw, flops) = peaks(name)
    emit({"phase": "card", "device": name, "count":
          torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "peaks": {"part": peak_name, "bytes_per_s": bw,
                    "bf16_flop_per_s": flops}})
    return name, smi, bw, flops


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT))})


def _rmsnorm_cases(gen, bw):
    from repro_torch.kernels.rmsnorm.kernel import rms_norm_2d
    from repro_torch.kernels.rmsnorm.ref import rms_norm_ref

    D = 4096
    w = (1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")
         ).to(torch.bfloat16)
    out = []
    for T in (1, 4, MAX_ACTIVE, MAX_LEN):
        x = torch.randn(T, D, generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        err = check_close(f"rmsnorm T={T}", rms_norm_2d(x, w),
                          rms_norm_ref(x, w), BF16_TOL)
        out.append({
            "shape": f"({T}, {D}) bf16", "main": T == MAX_ACTIVE,
            "max_abs_err": err, "tol": BF16_TOL,
            "kernel_ms": time_ms(lambda: rms_norm_2d(x, w)),
            "plain_ms": time_ms(lambda: rms_norm_ref(x, w)),
            "library_ms": time_ms(lambda: torch.nn.functional.rms_norm(
                x, (D,), w, eps=1e-6)),
            "bound_ms": (T * D * 4 + D * 2) / bw * 1e3, "bound_by": "bytes"})
    return out


def _attended_pairs(S: int, causal: bool, window: int) -> int:
    n = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        hi = i + 1 if causal else S
        n += hi - lo
    return n


def _flash_cases(gen, bw, flops):
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bshd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    H, K, hd = 32, 8, 128
    out = []
    # S = MAX_LEN is the main path's (padded) prefill length; 300 is ragged
    for S, window, softcap in ((128, 0, 0.0), (MAX_LEN, 0, 0.0),
                               (300, 0, 0.0), (512, 0, 0.0),
                               (512, 64, 30.0)):
        q, k, v = (torch.randn(1, S, n, hd, generator=gen, device="cuda"
                               ).to(torch.bfloat16) for n in (H, K, K))
        kw = dict(causal=True, window=window, softcap=softcap)
        err = check_close(f"flash S={S} window={window} softcap={softcap}",
                          flash_attention_bshd(q, k, v, **kw),
                          flash_attention_ref(q, k, v, **kw), BF16_TOL)
        library_ms = None
        if not window and not softcap:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library_ms = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
        op_s = 4 * H * hd * _attended_pairs(S, True, window) / flops
        byte_s = 2 * (2 * S * H * hd + 2 * S * K * hd) / bw
        out.append({
            "shape": f"q (1, {S}, {H}, {hd}) kv (1, {S}, {K}, {hd}) bf16 "
                     f"causal window={window} softcap={softcap}",
            "main": S == MAX_LEN and not window, "max_abs_err": err,
            "tol": BF16_TOL,
            "kernel_ms": time_ms(
                lambda: flash_attention_bshd(q, k, v, **kw)),
            "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, **kw)),
            "library_ms": library_ms, "bound_ms": max(op_s, byte_s) * 1e3,
            "bound_by": "operations" if op_s >= byte_s else "bytes"})
    return out


def _paged_cases(gen, bw):
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_rhd
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.launch.profile_steps import LENGTHS

    R, K, G, hd, ps = MAX_ACTIVE, 8, 4, 128, PAGE_SIZE
    mpr = -(-MAX_LEN // ps)
    P = R * mpr + 1
    # an inactive row (0, zeroed table), page boundaries, a full table
    lengths = list(LENGTHS)
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    table = torch.zeros(R, mpr, dtype=torch.int32, device="cuda")
    for r, n in enumerate(lengths):
        if r == 0:
            continue
        used = n // ps + 1
        table[r, :used] = perm[r * mpr:r * mpr + used].to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn(R, K * G, hd, generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    kp, vp = (torch.randn(P, ps, K, hd, generator=gen, device="cuda"
                          ).to(torch.bfloat16) for _ in range(2))
    out = []
    for window, softcap in ((0, 0.0), (64, 30.0)):
        kw = dict(window=window, softcap=softcap)

        def plain():
            return paged_attention_ref(q[:, None], kp, vp, table, lens,
                                       **kw)[:, 0]

        err = check_close(f"paged window={window} softcap={softcap}",
                          paged_attention_rhd(q, kp, vp, table, lens, **kw),
                          plain(), BF16_TOL)
        kv_bytes = sum(min(n + 1, window) if window else n + 1
                       for n in lengths) * K * hd * 2 * 2
        io_bytes = 2 * R * K * G * hd * 2 + R * mpr * 4 + R * 4
        out.append({
            "shape": f"R={R} K={K} G={G} hd={hd} ps={ps} MPR={mpr} bf16 "
                     f"lengths={lengths} window={window} softcap={softcap}",
            "main": not window, "max_abs_err": err, "tol": BF16_TOL,
            "kernel_ms": time_ms(
                lambda: paged_attention_rhd(q, kp, vp, table, lens, **kw)),
            "plain_ms": time_ms(plain), "library_ms": None,
            "bound_ms": (kv_bytes + io_bytes) / bw * 1e3,
            "bound_by": "bytes"})
    return out


def phase_kernels(seed: int, bw: float, flops: float):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    results = {"rmsnorm": _rmsnorm_cases(gen, bw),
               "flash_attention": _flash_cases(gen, bw, flops),
               "paged_attention": _paged_cases(gen, bw)}
    for name, cases in results.items():
        for case in cases:
            emit({"phase": "kernel", "name": name, **case})
    return results


def _prompts(vocab: int, seed: int, lens):
    """8 prompts over ``lens`` (three lengths, the first a whole number of
    pages): prompt 1 extends prompt 0 (a shared ``lens[0]``-token prefix),
    prompt 4 repeats prompt 1 exactly.  The engine admits two requests per
    replica per step, so 0, 1 and 4 land on replica 0 in that order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a, b, c = lens

    def draw(n):
        return [int(t) for t in rng.integers(0, vocab, n)]

    p0 = draw(a)
    p1 = p0 + draw(b - a)
    return [p0, p1, draw(c), draw(b), list(p1), draw(a), draw(c), draw(b)]


def _serve(cfg, params, prompts, gen_len, device, *, kill=False,
           replicas=2, max_len=MAX_LEN, slots=4, max_active=MAX_ACTIVE):
    from repro_torch.core import FaultInjector
    from repro_torch.serve import ServeEngine

    injector = None
    if kill:
        injector = FaultInjector()
        injector.schedule_replica_kill(KILL_STEP, replica_id=replicas - 1)
    eng = ServeEngine(cfg, params, device=device, num_replicas=replicas,
                      slots_per_replica=slots, max_len=max_len,
                      max_active=max_active, page_size=PAGE_SIZE,
                      fault_tolerant=True, heartbeat_period=0.1,
                      heartbeat_timeout_factor=10.0,
                      fault_injector=injector)
    try:
        rids = [eng.submit(p, gen_len) for p in prompts]
        t0 = time.perf_counter()
        results = eng.run()
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        reps = list(eng.router.replicas.values())
        for rep in reps:
            ok, why = rep.pool.audit()
            if not ok:
                raise AssertionError(f"replica {rep.id} pool audit: {why}")
        cons = eng.page_conservation()
        if (cons["pages_free"] + cons["pages_held"] != cons["pages_total"]
                or not cons["refs_ok"]):
            raise AssertionError(f"page conservation broken: {cons}")
        failures = [e for e in eng.events if e["event"] == "replica_failed"]
        lat = eng.request_latencies()
        return {
            "streams": [results.get(r) for r in rids],
            "dropped": len(eng.scheduler.failed_rids),
            "retried": len(eng.scheduler.retried_rids),
            "failures": failures, "wall": wall, "latencies": lat,
            "prefills": sum(r.prefills for r in reps),
            "decode_calls": sum(r.steps for r in reps),
            "prefix_hits": sum(r.pool.prefix_hits for r in reps),
        }
    finally:
        eng.shutdown()


def phase_tiny(seed: int):
    """The whole serving path on the card against the plain versions on
    the CPU: tiny granite in float32, one set of weights on both."""
    from repro_torch.models import get_config, init_params

    cfg = dataclasses.replace(get_config("granite-3-8b", tiny=True),
                              dtype=torch.float32)
    cpu = init_params(cfg, seed=seed, device="cpu")
    gpu = _tree_to(cpu, "cuda")
    prompts = _prompts(cfg.vocab_size, seed, (16, 24, 32))
    kw = dict(replicas=1, max_len=48, max_active=4)
    want = _serve(cfg, cpu, prompts, 8, "cpu", **kw)
    got = _serve(cfg, gpu, prompts, 8, "cuda", **kw)
    if got["streams"] != want["streams"] or None in got["streams"]:
        raise AssertionError(f"tiny float32 streams differ between the "
                             f"card and the CPU:\n{got['streams']}\n"
                             f"{want['streams']}")
    emit({"phase": "tiny", "requests": len(prompts),
          "tokens": sum(len(s) for s in got["streams"]),
          "streams_equal_cpu": True})


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _counters():
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bshd
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_rhd
    from repro_torch.kernels.rmsnorm.kernel import rms_norm_2d

    return {"rmsnorm": rms_norm_2d, "flash_attention": flash_attention_bshd,
            "paged_attention": paged_attention_rhd}


def phase_serve(seed: int):
    from repro_torch.models import get_config, init_params

    cfg = get_config("granite-3-8b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _prompts(cfg.vocab_size, seed, PROMPT_LENS)
    counters = _counters()
    L = cfg.num_layers
    runs = {}
    for label, kill in (("fault_free", False), ("replica_kill", True)):
        for fn in counters.values():
            fn.launches = 0
        res = _serve(cfg, params, prompts, GEN, "cuda", kill=kill)
        launches = {k: fn.launches for k, fn in counters.items()}
        want = {"rmsnorm": (2 * L + 1) * (res["prefills"]
                                          + res["decode_calls"]),
                "flash_attention": L * res["prefills"],
                "paged_attention": L * res["decode_calls"]}
        if launches != want or min(launches.values()) <= 0:
            raise AssertionError(f"{label}: launches {launches}, the path "
                                 f"implies {want}")
        if res["dropped"] or None in res["streams"]:
            raise AssertionError(f"{label}: dropped {res['dropped']}")
        if kill and not res["failures"]:
            raise AssertionError("the scheduled replica kill never fired")
        if not kill and res["failures"]:
            raise AssertionError(f"fault-free run failed a replica "
                                 f"(decode sentinel or heartbeat): "
                                 f"{res['failures']}")
        ttft = [t for _, t, _ in res["latencies"]]
        total = sorted(t for _, _, t in res["latencies"])
        tokens = sum(len(s) for s in res["streams"])
        emit({"phase": "serve", "run": label, "arch": cfg.name,
              "layers": L, "d_model": cfg.d_model,
              "padded_vocab": cfg.padded_vocab, "dtype": str(cfg.dtype),
              "replicas": 2, "requests": len(prompts), "gen": GEN,
              "prompt_lens": [len(p) for p in prompts],
              "tokens": tokens, "wall_s": res["wall"],
              "tok_s": tokens / res["wall"],
              "ttft_p50_ms": statistics.median(ttft) * 1e3,
              "latency_p50_ms": statistics.median(total) * 1e3,
              "latency_p99_ms": total[min(len(total) - 1,
                                          int(0.99 * len(total)))] * 1e3,
              "replica_failures": len(res["failures"]),
              "failure_reasons": [f["reason"] for f in res["failures"]],
              "retried": res["retried"], "dropped": res["dropped"],
              "prefills": res["prefills"],
              "decode_calls": res["decode_calls"],
              "prefix_hits": res["prefix_hits"], "launches": launches,
              "weights_init_s": init_s,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        runs[label] = (res, launches)
    a, b = runs["fault_free"][0], runs["replica_kill"][0]
    if a["streams"] != b["streams"]:
        diff = [i for i, (x, y) in enumerate(zip(a["streams"], b["streams"]))
                if x != y]
        raise AssertionError(f"streams after the replica kill differ from "
                             f"the uninterrupted run for requests {diff}")
    emit({"phase": "serve", "token_identical_after_kill": True})
    phase_steps(cfg, params, seed)
    return runs["fault_free"][1]


def phase_steps(cfg, params, seed: int, calls: int = 10):
    """Where a serve step's time goes: one decode step (``MAX_ACTIVE``
    rows) and one padded prefill of a 200-token prompt
    (``launch/profile_steps.serve_steps``), each run eagerly and ended by
    a synchronize as the engine runs it (host clock), and captured in a
    CUDA graph (device time alone).  The difference is the host's share:
    Python, dispatch and the launches the card waits for."""
    from repro_torch.launch.profile_steps import serve_steps

    steps = serve_steps(cfg, params, device="cuda", seed=seed,
                        max_active=MAX_ACTIVE, page_size=PAGE_SIZE,
                        max_len=MAX_LEN, prompt_len=200)
    out = {"phase": "steps", "decode_rows": MAX_ACTIVE,
           "prefill_tokens": 200, "prefill_padded_to": MAX_LEN}
    with torch.no_grad():
        for name, fn in steps.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
                torch.cuda.synchronize()
            eager = (time.perf_counter() - t0) / calls * 1e3
            device = time_ms(fn, iters=2, reps=3)
            out.update({f"{name}_eager_ms": eager,
                        f"{name}_device_ms": device,
                        f"{name}_host_share": 1.0 - device / eager})
    emit(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights, prompts and inputs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke.py: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, smi, bw, flops = phase_card()
    phase_build()
    cases = phase_kernels(args.seed, bw, flops)
    phase_tiny(args.seed)
    launches = phase_serve(args.seed)

    summary = []
    for kname, case_list in cases.items():
        main_case = next(c for c in case_list if c["main"])
        source, replaces = KERNELS[kname]
        summary.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/{source}", "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": max(c["max_abs_err"] for c in case_list),
            "ms": main_case["kernel_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "shape": main_case["shape"]})
    if not all(math.isfinite(s["ms"]) for s in summary):
        raise AssertionError("a kernel time is not finite")
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
