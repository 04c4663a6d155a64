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
                 on the same inputs on the card, at the shapes the serve
                 and train paths give it: max error and tolerance, kernel /
                 plain / library
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
                 device time alone (captured in a CUDA graph);
7. ``train-tiny`` — tiny granite in float32 trained on the card through
                 ``run_with_recovery``: a run with a fail-stop and raw
                 saves ends bit-equal to an uninterrupted card run, and
                 the card's losses match the CPU run's (plain versions);
8. ``train``   — granite-3-8b at full width (4 layers, S = 2048, global
                 batch 4 in 2 microbatches, float32 master weights, bf16
                 compute) through the ``Dependability`` facade with the
                 int8 device codec, async saves every 2 steps and a
                 fail-stop at step 5: two identical steps are bit-equal,
                 the step's eager and device time, then the protected run
                 (launch counters zeroed just before it and held to the
                 path after it), each save's bytes and seconds and the
                 restore's seconds.  The checkpoints go to a temporary
                 directory under ``build/`` that is removed afterwards.

Then the kernels summary (one JSON object), the ``nvidia-smi`` line, and
the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks (dense, NVIDIA data sheets): bytes/s, bf16 FLOP/s.
PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100 NVL": (3.9e12, 835e12),
         "H100 SXM": (3.35e12, 989e12)}
# float32 on the CUDA cores (no tensor cores), FLOP/s
FP32_PEAKS = {"H100 PCIe": 51e12, "H100 NVL": 60e12, "H100 SXM": 67e12}
BF16_TOL = 2e-2                  # tests/test_kernels.py's bf16 tolerance
FP32_TOL = 1e-4                  # float32 outputs (RMSNorm rstd, flash LSE)
# gradients: of the largest magnitude of the plain version's gradient
GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the train phase: full width, depth cut to 4 layers (40 layers of float32
# weights and AdamW moments, 16 B a parameter, do not fit 80 GB)
TRAIN_LAYERS = 4
TRAIN_SEQ = 2048
TRAIN_BATCH = 4
TRAIN_MICRO = 2
TRAIN_STEPS = 6
TRAIN_EVERY = 2
TRAIN_FAIL = 5
TRAIN_ROWS = TRAIN_BATCH // TRAIN_MICRO * TRAIN_SEQ   # tokens a microbatch
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
    # the TPU kernels had no backward: these supply the gradients of the
    # two above
    "rmsnorm_bwd": ("csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:26"),
    "flash_attention_bwd": ("csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention/kernel.py:77"),
    "ckpt_quantize": ("csrc/ckpt_codec.cu",
                      "src/repro/kernels/ckpt_codec/kernel.py:53"),
    "ckpt_dequantize": ("csrc/ckpt_codec.cu",
                        "src/repro/kernels/ckpt_codec/kernel.py:83"),
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


def check_grad(name: str, got, want, tol: float) -> float:
    """Raises unless |got - want| <= tol * max|want| + tol * |want|
    everywhere (a gradient is a sum over many terms taken in another
    order; the error follows the tensor's scale); returns the max abs
    error."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    diff = (got - want).abs()
    atol = tol * want.abs().max().item()
    if (diff > atol + tol * want.abs()).any():
        raise AssertionError(f"{name}: max abs error {diff.max().item():.3g}"
                             f" beyond {tol} of the largest magnitude "
                             f"{want.abs().max().item():.3g}")
    return diff.max().item()


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
    # the serve path's row counts, then the train path's (a microbatch of
    # TRAIN_SEQ tokens), where the forward also writes each row's rstd
    for T in (1, 4, MAX_ACTIVE, MAX_LEN, TRAIN_ROWS):
        x = torch.randn(T, D, generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        rstd = (torch.empty(T, dtype=torch.float32, device="cuda")
                if T == TRAIN_ROWS else None)
        err = check_close(f"rmsnorm T={T}", rms_norm_2d(x, w, rstd=rstd),
                          rms_norm_ref(x, w), BF16_TOL)
        if rstd is not None:
            want = torch.rsqrt(x.float().square().mean(-1) + 1e-6)
            err = max(err, check_close(f"rmsnorm rstd T={T}", rstd, want,
                                       FP32_TOL))
        out.append({
            "shape": f"({T}, {D}) bf16" + (" rstd" if rstd is not None
                                           else ""),
            "main": T == MAX_ACTIVE, "max_abs_err": err,
            "tol": BF16_TOL if rstd is None else
            {"y": BF16_TOL, "rstd": FP32_TOL},
            "kernel_ms": time_ms(lambda: rms_norm_2d(x, w, rstd=rstd)),
            "plain_ms": time_ms(lambda: rms_norm_ref(x, w)),
            "library_ms": time_ms(lambda: torch.nn.functional.rms_norm(
                x, (D,), w, eps=1e-6)),
            "bound_ms": (T * D * 4 + D * 2 + (T * 4 if rstd is not None
                                              else 0)) / bw * 1e3,
            "bound_by": "bytes"})
    return out


def _attended_pairs(S: int, causal: bool, window: int) -> int:
    n = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        hi = i + 1 if causal else S
        n += hi - lo
    return n


def _plain_lse(q, k, *, causal, window, softcap):
    """The log-sum-exp of each row's scores as the kernel defines them:
    float32 dot products times the scale, capped, masked -> (B, H, S)."""
    from repro_torch.layers.attention import NEG_INF, _mask, _softcap

    S, H, hd = q.shape[1:]
    kk = k.float().repeat_interleave(H // k.shape[2], dim=2)
    s = _softcap(torch.einsum("bshd,bthd->bhst", q.float(), kk)
                 * hd ** -0.5, softcap)
    pos = torch.arange(S, device=q.device)
    s = torch.where(_mask(pos, pos, causal=causal, window=window), s,
                    NEG_INF)
    return torch.logsumexp(s, dim=-1)


def _flash_cases(gen, bw, flops):
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bshd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    H, K, hd = 32, 8, 128
    B_train = TRAIN_BATCH // TRAIN_MICRO
    out = []
    # S = MAX_LEN is the serve path's (padded) prefill length, 300 is
    # ragged; the train path calls it a microbatch at a time with the LSE
    # (B_train, TRAIN_SEQ), here also with a window and a softcap
    for B, S, window, softcap in ((1, 128, 0, 0.0), (1, MAX_LEN, 0, 0.0),
                                  (1, 300, 0, 0.0), (1, 512, 0, 0.0),
                                  (1, 512, 64, 30.0),
                                  (B_train, TRAIN_SEQ, 0, 0.0),
                                  (B_train, TRAIN_SEQ, 512, 30.0)):
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device="cuda"
                               ).to(torch.bfloat16) for n in (H, K, K))
        kw = dict(causal=True, window=window, softcap=softcap)
        train = S == TRAIN_SEQ
        label = f"flash B={B} S={S} window={window} softcap={softcap}"
        if train:
            o, lse = flash_attention_bshd(q, k, v, lse=True, **kw)
            err = max(check_close(label, o, flash_attention_ref(q, k, v, **kw),
                                  BF16_TOL),
                      check_close(label + " lse", lse,
                                  _plain_lse(q, k, **kw), FP32_TOL))
            del o, lse
        else:
            err = check_close(label, flash_attention_bshd(q, k, v, **kw),
                              flash_attention_ref(q, k, v, **kw), BF16_TOL)
        kw_t = dict(iters=3, reps=3) if train else {}
        library_ms = None
        if not window and not softcap:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library_ms = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), **kw_t)
        op_s = 4 * B * H * hd * _attended_pairs(S, True, window) / flops
        byte_s = (2 * B * (2 * S * H * hd + 2 * S * K * hd)
                  + (B * H * S * 4 if train else 0)) / bw
        out.append({
            "shape": f"q ({B}, {S}, {H}, {hd}) kv ({B}, {S}, {K}, {hd}) "
                     f"bf16 causal window={window} softcap={softcap}"
                     + (" lse" if train else ""),
            "main": S == MAX_LEN and not window, "max_abs_err": err,
            "tol": {"o": BF16_TOL, "lse": FP32_TOL} if train else BF16_TOL,
            "kernel_ms": time_ms(
                lambda: flash_attention_bshd(q, k, v, lse=train, **kw),
                **kw_t),
            "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, **kw),
                                **kw_t),
            "library_ms": library_ms, "bound_ms": max(op_s, byte_s) * 1e3,
            "bound_by": "operations" if op_s >= byte_s else "bytes"})
        del q, k, v
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


def _codec_leaf(gen, shape, dtype):
    """A weight-like leaf with a first block of exact .5 ties (amax 127
    makes the scale 1) and an all-zero second block."""
    x = torch.randn(shape, generator=gen, device="cuda") * 0.02
    flat = x.view(-1)
    flat[:256] = torch.randn(256, generator=gen, device="cuda") * 20.0
    flat[:8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                            device="cuda")
    flat[256:512] = 0.0
    return x.to(dtype)


def _codec_cases(gen, bw):
    """Quantize and dequantize against their plain versions byte for byte
    at the embed leaf's shape (51200 x 4096, float32 master weights and
    bfloat16), a ragged leaf and a small one."""
    from repro_torch.kernels.ckpt_codec.kernel import (dequantize_blocks,
                                                       quantize_blocks)
    from repro_torch.kernels.ckpt_codec.ref import (dequantize_ref,
                                                    quantize_ref)

    quant, dequant = [], []
    for shape, dtype in (((51200, 4096), torch.float32),
                         ((51200, 4096), torch.bfloat16),
                         ((4095, 4097), torch.float32),
                         ((4, 4096), torch.float32)):
        x = _codec_leaf(gen, shape, dtype)
        q, sc = quantize_blocks(x)
        qr, sr = quantize_ref(x)
        label = f"{tuple(shape)} {str(dtype).split('.')[-1]}"
        if not (torch.equal(q, qr)
                and torch.equal(sc.view(torch.int32), sr.view(torch.int32))):
            bad = (q != qr).sum().item()
            raise AssertionError(f"ckpt quantize {label}: payload differs "
                                 f"from the plain version ({bad} bytes of "
                                 "q, or a scale)")
        y = dequantize_blocks(q, sc, shape)
        if not torch.equal(y.view(torch.int32),
                           dequantize_ref(q, sc, shape).view(torch.int32)):
            raise AssertionError(f"ckpt dequantize {label}: differs from "
                                 "the plain version")
        n, nb = x.numel(), q.shape[0]

        def library():
            # one call: int8 times float32 promotes to float32, one IEEE
            # multiply an element (the view and the slice are free)
            return torch.mul(q, sc[:, None]).view(-1)[:n].view(shape)

        if not torch.equal(y.view(torch.int32),
                           library().view(torch.int32)):
            raise AssertionError(f"ckpt dequantize {label}: differs from "
                                 "torch.mul(q, scales[:, None])")
        main = shape == (51200, 4096) and dtype == torch.float32
        common = {"shape": label, "main": main, "max_abs_err": 0.0,
                  "tol": "byte-identical", "bound_by": "bytes"}
        kw = dict(iters=3, reps=5)
        quant.append({
            **common, "library_ms": None,
            "kernel_ms": time_ms(lambda: quantize_blocks(x), **kw),
            "plain_ms": time_ms(lambda: quantize_ref(x), **kw),
            "bound_ms": (n * x.element_size() + n + nb * 4) / bw * 1e3})
        dequant.append({
            **common,
            "kernel_ms": time_ms(lambda: dequantize_blocks(q, sc, shape),
                                 **kw),
            "plain_ms": time_ms(lambda: dequantize_ref(q, sc, shape), **kw),
            "library_ms": time_ms(library, **kw),
            "bound_ms": (n + nb * 4 + n * 4) / bw * 1e3})
        del x, q, sc, qr, sr, y
    return quant, dequant


def _grads(forward, inputs, g):
    return torch.autograd.grad(forward(*inputs), inputs, g)


def _bwd_ms(forward, inputs, g, **kw) -> float:
    """Device time of the backward alone of a plain (autograd) function:
    its forward and backward captured together in a CUDA graph, less the
    forward captured alone (a backward is captured on the stream of its
    forward, so the two are captured together)."""
    both = time_ms(lambda: _grads(forward, inputs, g), **kw)
    return both - time_ms(lambda: forward(*inputs), **kw)


def _rmsnorm_bwd_cases(gen, bw):
    from repro_torch.kernels.rmsnorm.kernel import (rms_norm_2d,
                                                    rms_norm_2d_bwd)
    from repro_torch.kernels.rmsnorm.ref import rms_norm_ref

    R, D = TRAIN_ROWS, 4096                               # a microbatch
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        x, g = (torch.randn(R, D, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        w = (1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")
             ).to(dtype)
        rstd = torch.empty(R, dtype=torch.float32, device="cuda")
        rms_norm_2d(x, w, rstd=rstd)
        dx, dw = rms_norm_2d_bwd(g, x, w, rstd)
        leaves = (x.clone().requires_grad_(), w.clone().requires_grad_())
        gx, gw = _grads(rms_norm_ref, leaves, g)
        tol = GRAD_TOL[dtype]
        err = max(check_grad(f"rmsnorm_bwd dx {dtype}", dx, gx, tol),
                  check_grad(f"rmsnorm_bwd dw {dtype}", dw, gw, tol))

        def library(xl, wl):
            return torch.nn.functional.rms_norm(xl, (D,), wl, eps=1e-6)

        es = x.element_size()
        out.append({
            "shape": f"({R}, {D}) {str(dtype).split('.')[-1]}",
            "main": dtype == torch.bfloat16, "max_abs_err": err, "tol": tol,
            "kernel_ms": time_ms(
                lambda: rms_norm_2d_bwd(g, x, w, rstd)),
            "plain_ms": _bwd_ms(rms_norm_ref, leaves, g),
            "library_ms": _bwd_ms(library, leaves, g),
            "bound_ms": ((3 * R * D + 2 * D) * es + R * 4) / bw * 1e3,
            "bound_by": "bytes"})
        del x, g, w, leaves, gx, gw, dx, dw
    return out


def _flash_bwd_cases(gen, bw, flops, fp32_flops):
    """The backward at the train shape (a microbatch: B = 2, S = 2048,
    32/8 heads of 128) in bfloat16 and float32, and a softcap + window
    case; against autograd of the plain version on the same inputs."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bshd, flash_attention_bshd_bwd)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    B, S, H, K, hd = TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, 32, 8, 128
    out = []
    for dtype, window, softcap in ((torch.bfloat16, 0, 0.0),
                                   (torch.float32, 0, 0.0),
                                   (torch.bfloat16, 512, 30.0)):
        q, do = (torch.randn(B, S, H, hd, generator=gen, device="cuda"
                             ).to(dtype) for _ in range(2))
        k, v = (torch.randn(B, S, K, hd, generator=gen, device="cuda"
                            ).to(dtype) for _ in range(2))
        kw = dict(causal=True, window=window, softcap=softcap)
        o, lse = flash_attention_bshd(q, k, v, lse=True, **kw)
        got = flash_attention_bshd_bwd(q, k, v, o, do, lse, **kw)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        def plain(qq, kk, vv):
            return flash_attention_ref(qq, kk, vv, **kw)

        want = _grads(plain, leaves, do)
        tol = GRAD_TOL[dtype]
        err = max(check_grad(f"flash_bwd {n} {dtype} window={window} "
                             f"softcap={softcap}", a, b, tol)
                  for n, a, b in zip(("dq", "dk", "dv"), got, want))
        again = flash_attention_bshd_bwd(q, k, v, o, do, lse, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("flash_bwd is not deterministic")
        library_ms = None
        if not window and not softcap:
            lib = [t.transpose(1, 2).clone().requires_grad_()
                   for t in (q, k, v)]

            def sdpa(qq, kk, vv):
                return torch.nn.functional.scaled_dot_product_attention(
                    qq, kk, vv, is_causal=True, enable_gqa=True)

            library_ms = _bwd_ms(sdpa, lib, do.transpose(1, 2).contiguous(),
                                 iters=3, reps=3)
            del lib
        pairs = _attended_pairs(S, True, window)
        peak = flops if dtype == torch.bfloat16 else fp32_flops
        op_s = 10 * hd * pairs * H * B / peak
        es = q.element_size()
        byte_s = ((4 * B * S * H * hd + 4 * B * S * K * hd) * es
                  + B * H * S * 4) / bw
        out.append({
            "shape": f"q (B={B}, {S}, {H}, {hd}) kv ({S}, {K}, {hd}) "
                     f"{str(dtype).split('.')[-1]} causal window={window} "
                     f"softcap={softcap}",
            "main": dtype == torch.bfloat16 and not window,
            "max_abs_err": err, "tol": tol,
            "kernel_ms": time_ms(
                lambda: flash_attention_bshd_bwd(q, k, v, o, do, lse, **kw),
                iters=3, reps=3),
            "plain_ms": _bwd_ms(plain, leaves, do, iters=3, reps=3),
            "library_ms": library_ms,
            "bound_ms": max(op_s, byte_s) * 1e3,
            "bound_by": "operations" if op_s >= byte_s else "bytes"})
        del q, k, v, do, o, lse, got, again, leaves, want
        torch.cuda.empty_cache()
    return out


def phase_kernels(seed: int, bw: float, flops: float, fp32_flops: float):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    quant, dequant = _codec_cases(gen, bw)
    torch.cuda.empty_cache()
    results = {"rmsnorm": _rmsnorm_cases(gen, bw),
               "flash_attention": _flash_cases(gen, bw, flops),
               "paged_attention": _paged_cases(gen, bw),
               "rmsnorm_bwd": _rmsnorm_bwd_cases(gen, bw),
               "flash_attention_bwd": _flash_bwd_cases(gen, bw, flops,
                                                       fp32_flops),
               "ckpt_quantize": quant, "ckpt_dequantize": dequant}
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
    from repro_torch.kernels.ckpt_codec.kernel import (dequantize_blocks,
                                                       quantize_blocks)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bshd, flash_attention_bshd_bwd)
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_rhd
    from repro_torch.kernels.rmsnorm.kernel import (rms_norm_2d,
                                                    rms_norm_2d_bwd)

    return {"rmsnorm": rms_norm_2d, "flash_attention": flash_attention_bshd,
            "paged_attention": paged_attention_rhd,
            "rmsnorm_bwd": rms_norm_2d_bwd,
            "flash_attention_bwd": flash_attention_bshd_bwd,
            "ckpt_quantize": quantize_blocks,
            "ckpt_dequantize": dequantize_blocks}


def phase_serve(seed: int):
    from repro_torch.models import get_config, init_params

    cfg = get_config("granite-3-8b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _prompts(cfg.vocab_size, seed, PROMPT_LENS)
    counters = {k: fn for k, fn in _counters().items()
                if k in ("rmsnorm", "flash_attention", "paged_attention")}
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


def _tree_equal(a, b) -> bool:
    from repro_torch.tree import flatten_named

    fa, fb = flatten_named(a), flatten_named(b)
    return ([n for n, _ in fa] == [n for n, _ in fb]
            and all(x.dtype == y.dtype and torch.equal(x, y)
                    for (_, x), (_, y) in zip(fa, fb)))


def _ckpt_root() -> Path:
    """Checkpoints of the train phases: a directory of the checkout that
    git ignores; each run takes a temporary directory under it and
    removes it."""
    root = ROOT / "build" / "chip_smoke_ckpt"
    root.mkdir(parents=True, exist_ok=True)
    return root


def _protected_run(state, data, step_fn, ckpt_dir, *, steps, fail_at,
                   **config):
    """``run_with_recovery`` through the facade with a fail-stop at
    ``fail_at``; returns (state, info, facade, train-step calls, the
    metrics of every step of every attempt, in order)."""
    from repro_torch.core import (Dependability, DependabilityConfig,
                                  FaultInjector, run_with_recovery)

    dep = Dependability(DependabilityConfig(
        checkpoint_dir=ckpt_dir, policy_mode="every_n",
        every_n=TRAIN_EVERY, signal_detection=False, **config)).start()
    dep.register_local_state(data)
    dep.register_global_state(state)
    injector = FaultInjector()
    injector.schedule_failstop(fail_at)
    calls = [0]
    metrics = []

    def counted(st, batch):
        calls[0] += 1
        return step_fn(st, batch)

    try:
        out, info = run_with_recovery(
            dep, counted, state, data, steps, fault_injector=injector,
            on_metrics=lambda step, rec: metrics.append(rec))
        torch.cuda.synchronize()
    finally:
        dep.stop()
    if info["status"] != "done" or info["restarts"] != 1:
        raise AssertionError(f"protected run: {info['status']}, "
                             f"{info['restarts']} restarts")
    # the history keeps the last attempt's steps only: every step's
    # metrics come through on_metrics, one record a train-step call
    losses = [m["loss"] for m in metrics]
    if len(losses) != calls[0] or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"protected run: {calls[0]} train-step calls, "
                             f"losses {losses}")
    return out, info, dep, calls[0], metrics


def phase_train_tiny(seed: int):
    """Tiny granite in float32 on the card: a run with a fail-stop and raw
    saves ends bit-equal to an uninterrupted card run; the card's losses
    match the CPU's (plain versions) to float32 tolerance (1e-4 relative:
    the two sum in different orders)."""
    from repro_torch.data import make_pipeline
    from repro_torch.models import get_config
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.step import metrics_to_host

    steps = 9
    cfg = dataclasses.replace(get_config("granite-3-8b", tiny=True),
                              dtype=torch.float32)
    cpu_state = init_state(cfg, seed=seed, device="cpu")
    step_fn = make_train_step(cfg, total_steps=steps, warmup_steps=1)
    losses = {}
    for device in ("cpu", "cuda"):
        state = _tree_to(cpu_state, device)
        data = make_pipeline(cfg, 32, 4, seed=seed)
        losses[device] = []
        for _ in range(steps):
            state, m = step_fn(state, data.next_batch())
            losses[device].append(metrics_to_host(m)["loss"])
    uninterrupted = state
    for a, b in zip(losses["cuda"], losses["cpu"]):
        if not abs(a - b) <= 1e-4 * max(1.0, abs(b)):
            raise AssertionError(f"tiny train: card losses {losses['cuda']}"
                                 f" vs CPU {losses['cpu']}")
    tmp = tempfile.mkdtemp(dir=_ckpt_root())
    try:
        out, info, _, _, _ = _protected_run(
            _tree_to(cpu_state, "cuda"), make_pipeline(cfg, 32, 4, seed=seed),
            step_fn, tmp, steps=steps, fail_at=TRAIN_FAIL, async_save=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not _tree_equal(out, uninterrupted):
        raise AssertionError("tiny train: the recovered run's state differs "
                             "from the uninterrupted run's")
    emit({"phase": "train-tiny", "arch": cfg.name, "dtype": "float32",
          "steps": steps, "fail_stop_at": TRAIN_FAIL,
          "restarts": info["restarts"], "recovered_bit_equal": True,
          "card_losses": losses["cuda"], "cpu_losses": losses["cpu"]})


def _train_launches(L: int, microbatches: int, calls: int):
    """Launches the train path implies: per microbatch each of L layers
    runs its 2 RMSNorms and 1 attention forward twice (the forward and the
    recomputation of the backward), the final norm once; each backward
    once."""
    return {"rmsnorm": calls * microbatches * (4 * L + 1),
            "rmsnorm_bwd": calls * microbatches * (2 * L + 1),
            "flash_attention": calls * microbatches * 2 * L,
            "flash_attention_bwd": calls * microbatches * L}


def phase_train(seed: int):
    """granite-3-8b at full width (depth cut to TRAIN_LAYERS) trained
    through the facade with the int8 device codec."""
    from repro_torch.data import make_pipeline
    from repro_torch.launch.profile_steps import profile_step
    from repro_torch.models import get_config
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.step import metrics_to_host
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              num_layers=TRAIN_LAYERS)
    L = cfg.num_layers
    tmp = tempfile.mkdtemp(dir=_ckpt_root())
    disk_free = shutil.disk_usage(tmp).free
    emit({"phase": "train", "disk_free_gb": disk_free / 1e9,
          "ckpt_dir": str(Path(tmp).relative_to(ROOT))})
    try:
        torch.cuda.reset_peak_memory_stats()
        state = init_state(cfg, seed=seed, device="cuda")
        n_params = sum(t.numel() for t in leaves(state["params"]))
        eligible = sum(1 for t in leaves(state)
                       if t.is_floating_point() and t.numel() >= 1024)
        step_fn = make_train_step(cfg, microbatches=TRAIN_MICRO,
                                  total_steps=TRAIN_STEPS)
        data = make_pipeline(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
        batch = data.peek_batch(0)

        # determinism: two steps from one state, the same bits (the second
        # one timed on the host clock, ended by a synchronize)
        s1, m1 = step_fn(state, batch)
        h1 = metrics_to_host(m1)
        t0 = time.perf_counter()
        s2, m2 = step_fn(state, batch)
        h2 = metrics_to_host(m2)
        eager_ms = (time.perf_counter() - t0) * 1e3
        same = _tree_equal(s1, s2)
        if not (same and h1["loss"] == h2["loss"]
                and h1["grad_norm"] == h2["grad_norm"]):
            raise AssertionError(f"two identical steps differ: {h1} vs {h2}"
                                 f", states equal: {same}")
        emit({"phase": "train", "check": "two identical steps",
              "loss": [h1["loss"], h2["loss"]],
              "grad_norm": [h1["grad_norm"], h2["grad_norm"]],
              "states_bit_equal": same})
        del s1, s2, m1, m2
        prof = profile_step(lambda: step_fn(state, batch), calls=1)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        emit({"phase": "train", "check": "step", "arch": cfg.name,
              "layers": L, "d_model": cfg.d_model,
              "params": n_params, "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
              "microbatches": TRAIN_MICRO, "eager_ms": eager_ms,
              "profiled_wall_ms": prof["wall_ms"],
              "device_ms": prof["device_ms"],
              "host_share": 1.0 - prof["device_ms"] / eager_ms,
              "tokens_per_s": tokens / (eager_ms / 1e3),
              "kernels_per_step": prof["kernels_per_call"],
              "device_ms_by_group": prof["device_ms_by_group"],
              "top_kernels_ms": prof["top_kernels_ms"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

        # the main path: the protected run, counters zeroed just before it
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out, info, dep, calls, metrics = _protected_run(
            state, data, step_fn, tmp, steps=TRAIN_STEPS,
            fail_at=TRAIN_FAIL, async_save=True, device_codec=True)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        saves, restores = len(dep.save_history), len(dep.restore_seconds)
        want = {**_train_launches(L, TRAIN_MICRO, calls),
                "paged_attention": 0,
                "ckpt_quantize": eligible * saves,
                "ckpt_dequantize": eligible * restores}
        if launches != want or min(v for k, v in launches.items()
                                   if k != "paged_attention") <= 0:
            raise AssertionError(f"train: launches {launches}, the path "
                                 f"implies {want}")
        if int(out["step"]) != TRAIN_STEPS:
            raise AssertionError(f"train: ended at step {int(out['step'])}")
        emit({"phase": "train", "check": "protected run",
              "status": info["status"], "restarts": info["restarts"],
              "events": [h["event"] for h in info["history"]
                         if "event" in h],
              "train_step_calls": calls,
              "steps_losses": [(m["step"], m["loss"]) for m in metrics],
              "wall_s": wall,
              "saves": [{"step": st.step, "bytes": st.bytes_written,
                         "snapshot_s": st.snapshot_seconds,
                         "write_s": st.write_seconds}
                        for st in dep.save_history],
              "fp32_bytes_per_save": sum(
                  t.numel() * t.element_size() for t in leaves(state)),
              "restore_s": dep.restore_seconds,
              "eligible_leaves": eligible, "launches": launches,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        del state, out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights, prompts and inputs")
    args = ap.parse_args(argv)
    # the train step's fixed cuBLAS workspace (determinism) is read when
    # cuBLAS starts: set it before any CUDA work
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    cases = phase_kernels(args.seed, bw, flops, FP32_PEAKS[peaks(name)[0]])
    torch.cuda.empty_cache()
    phase_tiny(args.seed)
    serve = phase_serve(args.seed)
    torch.cuda.empty_cache()
    phase_train_tiny(args.seed)
    train = phase_train(args.seed)

    summary = []
    for kname, case_list in cases.items():
        main_case = next(c for c in case_list if c["main"])
        source, replaces = KERNELS[kname]
        by_path = {"serve": serve.get(kname, 0), "train": train[kname]}
        summary.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/{source}", "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
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
