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
                 greedy streams must agree token for token; then
                 ``tiny-slots``, the same from the slot pool
                 (``paged=False``, 4 rows): card and CPU agree, and both
                 equal the paged streams;
5. ``serve``   — granite-3-8b at full width (40 layers, random weights
                 from ``--seed``) on 2 replicas sharing one set of weights:
                 8 requests with shared prefixes and an exact repeat, once
                 without faults and once with replica 1 killed at engine
                 step 5.  Every launch counter is zeroed just before each
                 run and must match the path afterwards; both runs must
                 serve every request, the streams must be identical, the
                 page accounting must hold and the decode sentinel must
                 stay quiet; then ``serve-slots``, the fault-free run from
                 the slot pool (``paged=False``, 2 replicas of 8 slots of
                 288 positions, so every decode step has the paged run's
                 shapes): the streams equal the paged run's token for
                 token, nothing dropped, the sentinel quiet (its entropy
                 printed), no slot held, launches held to the path (the
                 decode's attention is the paged kernel over a page view
                 of the rows); then ``serve-standby`` at 8 of the 40
                 layers (the serve phase's first 8): a fault-free slot
                 run, then the same engine with one warm standby
                 restored through ``make_standby_source`` from a raw
                 ``CheckpointManager`` save of the parameters (under
                 ``build/``, removed after), replica 1 killed at step 5:
                 the standby activated after the failure, nothing
                 dropped, streams token-identical to the fault-free
                 run's, its parameters bit-equal to the live ones, the
                 save's bytes and seconds and the restore's seconds
                 printed; then ``serve-predrain`` (after
                 ``steps``): the
                 same engine with an ``Observability``, an
                 ``AnomalyEngine`` (step-time drift: factor 2, 3 in a row,
                 3 warm-up steps) as its ``risk_source`` and a pre-drain
                 threshold of 0.8, replica 1 sleeping at engine steps 3-14
                 (sized from the fault-free run's step timings) and killed
                 at step 16: exactly one pre-drain, of replica 1, the kill
                 never fired, nothing dropped, streams token-identical to
                 the fault-free run, detect-before-act green, launches
                 held to the path; the precursor-to-pre-drain time and the
                 timeline printed;
6. ``steps``   — one decode step (paged, and over 8 slot-pool rows)
                 and one prefill at the serve phase's shapes, eager (as
                 the engine runs them) against their device time alone
                 (captured in a CUDA graph), and the
                 decode step's device ms in the paged-attention and
                 RMSNorm kernels beside the tree's before their redesign;
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
                 directory under ``build/`` that is removed afterwards;
9. ``train-tiny-sdc`` — tiny granite in float32 with raw delta saves, the
                 scrubber over every leaf and a bit-flip scheduled in a
                 named leaf: the scrubber names exactly that leaf, one
                 rollback, the final state bit-equal to an uninterrupted
                 card run, the losses equal to the same run's on the CPU;
10. ``train-sdc`` — granite-3-8b at full width (4 layers) through the
                 facade with delta saves and the int8 device codec, the
                 scrubber and a bit-flip in an exponent bit of
                 ``params.blocks.l0.mlp.w_in`` at step 7: the leaf named,
                 one restart, a finite loss every step call, launch
                 counters held to the path, each save's dirty/total
                 blocks, hash ms, snapshot s and write s; then a frozen
                 state (k blocks of one leaf changed on the card) gives a
                 delta save of exactly k dirty blocks whose restore
                 through the chain is bit-equal to a full save's;
10b. ``train-obs`` — granite-3-8b at full width (4 layers) as train-sdc
                 runs it, with the telemetry plane: an ``Observability``
                 with a JSONL sink, the ``risk_adjusted`` policy, an
                 ``AnomalyEngine`` on the bus and the proactive hook;
                 straggles at steps 5-7 (5 warm steps each), a bit-flip at
                 step 10: a precursor for host 0, a forced save before the
                 flip with the policy's interval contracted, one incident
                 (corruption -> restore -> resume) with its MTTR, the JSONL
                 log equal to the ring, the bundle's four files parsed, the
                 log's scenario valid, launches held to the path, and the
                 instrumentation's host time under 2 % of the step's eager
                 ms;
11. ``train-abft`` — granite-3-8b at full width, 2 layers, S = 2048, one
                 sequence: 3 steps with ``impl="abft"`` against 3 plain
                 steps from the same state (losses within bf16
                 tolerance), no detection on clean steps, two identical
                 ABFT steps bit-equal, launches held to the path (every
                 abft_matmul launch on the tensor-core route), then one
                 step of each profiled: eager and device ms;
12. ``tiny-ssm`` — tiny falcon-mamba in float32 served through
                 ``ServeEngine``'s slot pool on the card (kernels) and on
                 the CPU (plain versions): the greedy streams agree token
                 for token; then on the card, prefill(p) followed by k
                 decode steps gives the logits and state of prefill(p +
                 generated) within 1e-4 of the largest magnitude;
13. ``serve-ssm`` — falcon-mamba-7b at full width, 32 of 64 layers (
                 bf16, random weights from ``--seed``; the granite weights
                 are freed first) on 2 replicas of 4 slots sharing one set
                 of weights, the serve phase's 8 prompts and 32 new
                 tokens, fault-free and with replica 1 killed at engine
                 step 5: nothing dropped, streams identical, the sentinel
                 quiet fault-free (its entropy printed), launches held to
                 the path (a scan a layer a prefill, L + 1 RMSNorms a
                 model call, no attention, every scan on the TMA route);
                 then ``steps-ssm``, one decode step over the 4
                 slots and one 200-token prefill, eager against device
                 time, and the prefill's scan launches profiled beside
                 its device time (the readings before the scan's
                 redesign were taken at 64 layers);
14. ``tiny-fwi`` — the FWI case study at tests/test_torch_fwi.py's size
                 in float32 on the card and on the CPU from the same
                 observed data: the misfit trajectories within 1e-4
                 relative, the models within 1 m/s where the gradient is
                 not near 0;
15. ``fwi``    — the paper's FWI case study at the Marmousi model's
                 extent (300 x 920 cells of 10 m, nt 2000, 16 shots in
                 2 groups of 8): one iteration's eager and device ms,
                 host share and peak memory; the main path, a survey in
                 local scope over 4 shot shards with async saves every
                 iteration and a fail-stop at iteration 2 (4 shard files
                 restored and remapped, the misfit falling, no kernel
                 launched); the paper's eq.-2 overhead of sync, async and
                 async int8 saves every iteration, the median of 2 runs
                 each; every protected run's model, and the recovered
                 run's whole state, bit-equal to the unprotected run's;
16. ``train-tiny-ssm`` — ``train-tiny`` for tiny falcon-mamba;
17. ``train-ssm`` — falcon-mamba-7b at full width (2 layers) trained as
                 the train phase trains granite: two identical steps
                 bit-equal, the step's eager and device ms, tokens/s and
                 the scan forward and backward device ms; a protected run
                 with raw saves bit-equal to an uninterrupted run; the
                 train phase's protected run (int8 device codec, async
                 saves every 2, a fail-stop at step 5), launch counters
                 held to the path (a scan forward a layer twice and a
                 scan backward once a microbatch);
18. ``tiny-moe`` — tiny mixtral in float32, the engine's streams and the
                 ``launch/serve_lm`` lockstep streams on the card equal to
                 the CPU's;
19. ``serve-moe`` — mixtral-8x7b at full width (4 of 32 layers): the
                 ``launch/serve_lm`` twin (8 x 256 tokens in lockstep, 32
                 new), then 2 paged replicas serving the serve phase's 8
                 requests fault-free and with replica 1 killed at step 5:
                 nothing dropped, launches held to each path, the decode
                 sentinel's entropy under its ceiling; then
                 ``steps-moe``;
20. ``elastic`` — granite-3-8b at full width (1 of 40 layers, S 1024,
                 global batch 8) on 4 ranks sharing the card (2 hosts x 2
                 ranks, tensors exchanged through files in the run's directory between
                 gloo barriers, ``sharding/launch.py``)
                 through ``run_elastic``: host 1's heartbeats stop after
                 step 3 (the mesh shrinks (2, 2) -> (1, 2), resharded
                 from the pause's checkpoint) and start again after step
                 5 (it grows back): the events and grids ``largest_grid``
                 gives, no step lost, each step's loss and gradient norm
                 within 1e-2 (absolute; relative for the norm) of an
                 uninterrupted single-rank run at the same learning rate
                 (its peak from step 1), each step's change of the
                 parameters' sum of squares within 1e-2 of that run's
                 mean change a step from the change its step makes,
                 every restore bit-equal to
                 the save it came from (a position hash of every leaf over
                 the mesh), launches held to the path;
21. ``elastic-moe`` — mixtral-8x7b at full width (1 of 32 layers), (2, 2,
                 2) over 4 hosts x 2 ranks, experts degraded, host 1
                 killed after step 3: the survivor grid, the degraded
                 experts and the manifest's mesh equal ``best_grid3d``'s,
                 no step lost, each step's loss, gradient norm and
                 change of the parameters' sum of squares within 1e-2 of
                 a single-rank run that degrades the same experts at the
                 same step,
                 the restores bit-equal, launches held;
22. ``compress`` — ``compressed_psum`` of one granite-3-8b layer's
                 float32 gradient leaves over 2 ranks for 8 rounds: the
                 reduced values the rank-order mean of the peers'
                 dequantized payloads bit for bit, the residual exactly
                 ``g_eff - deQ(Q(g_eff))``, the long-run mean converging,
                 quantize and dequantize launches counted, its ms beside
                 the plain rank-order sum of the same leaves over the
                 same transport (``comm.ordered_sum``);
23. ``chaos-sim`` — ``ControlPlaneSim`` through every canned trace
                 (``scenarios/*.json``) at 1000 virtual hosts, and
                 ``axis_loss`` at 1000 hosts x 2 devices over a
                 mixtral-8x7b (dp, tp, ep) grid: every invariant green;
                 ticks, detections, detection latency, final dp and wall
                 seconds (host work on the card's machine);
24. ``chaos-serve`` — ``ServeScenarioDriver`` replays ``compound`` (4
                 replicas x 2 slots, 4 warm standbys) and
                 ``flash_crowd_paged`` (2 paged replicas, 64 rows) against
                 granite-3-8b at full width and 8 of 40 layers (its
                 host-bound engine steps cut to pay for 26-27), one set
                 of weights shared: zero drop, conservation, monotonic
                 drain, page
                 conservation, the kills and storm failures landed, every
                 stream equal to the port's B=1 prefill and decode on the
                 card, launches held to the path;
25. ``chaos-train`` — ``compound`` through ``run_scenario_elastic`` on 8
                 ranks sharing the card (4 hosts x 2 ranks, (4, 2)),
                 granite-3-8b at full width and 1 of 40 layers, S 1024,
                 global batch 8, 20 steps, raw saves every 2, the
                 scrubber over every leaf, the telemetry plane on rank 0:
                 agreed rollbacks for the storm's flips, hosts 2 and 3
                 shrunk at 6 and grown at 16, no step lost, the trajectory
                 within the elastic phase's limits of a single-rank run,
                 the log back to compound.json and replayed through the
                 simulator, every incident closed, launches held to the
                 path (the train step's and the scrubber's block hashes);
26. ``tiny-families`` — the TINY configs of gemma-7b, recurrentgemma-2b,
                 phi3.5-moe and qwen1.5-110b in float32 through
                 ``ServeEngine`` on the card and on the CPU, the streams
                 token for token; qwen2-vl-2b's prefill (text, an image's
                 (t, h, w) ids, text) and decode steps and hubert-xlarge's
                 encoder forward, card against CPU within 1e-4;
27. ``serve-families`` — at full width, random weights from ``--seed``,
                 one model at a time: gemma-7b (28 layers, 2 paged
                 replicas, the serve phase's 8 requests, fault-free);
                 recurrentgemma-2b (26 layers, 2 x 4 slots, the 8
                 requests and one of 2300 tokens past its window of
                 2048, fault-free and replica 1 killed at step 5, streams
                 token-identical); phi3.5-moe and qwen1.5-110b at 4
                 layers (16 new, fault-free); qwen2-vl-2b (28 layers, 2 x
                 (64 text + a 24 x 24 image + 16 text) then 16 decode
                 steps in bf16, then in float32 each within 1e-4 of a
                 full forward's last position); hubert-xlarge (48
                 layers, 4 x 1000 frames, within 2e-2 of the same
                 forward through the plain attention); nothing dropped,
                 the decode sentinel on at its defaults (each run's
                 entropy beside its ceiling),
                 launches held to each path, the flash kernel launched at
                 head_dim 256 and 80 and the paged kernel at G hd 4096;
                 then ``steps-families``, each decoding family's decode
                 step eager against device time;
28. ``train-tiny-families`` — the six TINY configs in float32, two steps
                 of 2 microbatches on the card and on the CPU from one
                 state (qwen2-vl over an image's M-RoPE ids): the losses
                 within 1e-4; then tiny recurrentgemma (RG-LRU, the
                 reference's unstacked layout) as ``train-tiny`` runs
                 granite: a fail-stop run with raw saves bit-equal to an
                 uninterrupted card run;
29. ``train-families`` — at full width, random weights from ``--seed``,
                 one model at a time, through ``init_state`` and
                 ``make_train_step``: gemma-7b (4 of 28 layers, 16 heads
                 of 256, S 2048, batch 4 in 2 microbatches),
                 recurrentgemma-2b (one block of 13 layers: 9 RG-LRU, 4
                 LOCAL with 16 padded q heads of 256 over one kv head, S
                 4096 past the window of 2048, batch 2 in 2), hubert-xlarge
                 (48 layers, 16 heads of 80, 4 x 1000 frames in 2) and
                 qwen2-vl-2b (28 layers, padded heads, M-RoPE over a 24 x
                 24 image's ids, S 2048, batch 4 in 2): two identical steps
                 bit-equal (loss, grad norm, every state leaf's digest)
                 with the launch counters held to the path, the step's
                 eager and device ms, tokens/s and peak memory, one
                 microbatch's bf16 gradients through the kernels as close
                 to the float32 model's as through the plain attention
                 (each leaf, 1.25x), the padded heads' gradient rows 0.
30. ``launch`` — the launch tooling (``launch/{mesh,shapes,dryrun,
                 roofline}.py``): the dry run over the 20 train cells (10
                 archs x the production meshes (16, 16) and (2, 16, 16),
                 rank 0 traced on the meta device) and the roofline over
                 the 10 on (16, 16), each one background process started
                 after the build (the dry run's cells 3 at a time, each
                 process one thread): every cell ``ok``, each one's peak per
                 rank beside the card's memory, the roofline's terms; then
                 two rank probes, rank 0 of (16, 16) at train_4k for
                 granite-3-8b (kv heads stored whole) and falcon-mamba-7b
                 (SSM channels over "model"): one real step of the rank
                 from random shards with the recording comm standing in
                 for its 255 peers, its measured peak held to the dry
                 run's estimate (no more than 10 % below it), its device
                 time printed beside the roofline's per-rank compute and
                 memory terms, its launches held to the path.

The kernel phase also holds selective_scan to its plain version within
1e-5 + 1e-5 |want| (tests/test_kernels.py) at the serve shape (B 1,
S 256, Di 8192, N 16) with h0 zero and random, a ragged S, B 2, N 4 and
a ragged Di (the 4-byte-copy route), each with its route, share of the
bound and the bound's exponential, byte and fp32 legs, then the scan's
registers, spills and shared memory from the build's ``-Xptxas -v`` log;
and the scan's backward kernel against its plain reverse scan at one
train-ssm microbatch (B 2, S 2048, Di 8192, N 16) and at a ragged S and
Di with a carried state: every gradient within 1e-4 of its largest
magnitude, two launches bit-equal, its time beside its bound (bytes and
exponentials) and its registers, spills and shared memory;
Flash attention is also held at head_dim 256 (gemma-7b's prefill,
recurrentgemma-2b's long windowed prompt over one kv head) and 80
(hubert-xlarge's non-causal encoder), its backward at the same families'
train microbatches (gemma-7b B 2 x 2048, recurrentgemma-2b B 1 x 4096
with its window, hubert-xlarge 4 x 1000, each in bf16 and in float32,
with SDPA's backward beside each and the build's registers and spills),
and paged decode at gemma-7b's G 1
x 256 and recurrentgemma-2b's G 16 x 256 = 4096; and block_hash
bit-equal to its plain version
(the embed leaf, every element size, a ragged leaf, one grouped launch
over the full-width train state) and abft_matmul to its float32 plain
version at one microbatch's ``w_in`` and its two backward contractions
(the tensor-core route, two launches bit-equal, the CUDA-core SGEMM's
reading and time beside it), with the verifier's checks (a single error
corrected, a checksum hit leaving the data intact, two errors detected
and not corrected); the RMSNorm backward's two launches are bit-equal.
Paged attention is bit-equal on a repeated call and through a 40-entry
table, with its split pass and combine profiled; the RMSNorm forward is
timed beside the harness's latency floor (a one-element ``zero_``); both
also without programmatic dependent launch.

Then the kernels summary (one JSON object, launches by path: serve,
train, sdc, abft, serve_ssm, fwi, train_ssm, train_obs, serve_predrain,
serve_slots, serve_standby, serve_moe, elastic, elastic_moe, compress,
chaos_serve, chaos_train, serve_families, train_families, launch),
the ``nvidia-smi`` line,
and the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import atexit
import ctypes
import dataclasses
import gc
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

BF16_TOL = 2e-2                  # tests/test_kernels.py's bf16 tolerance
FP32_TOL = 1e-4                  # float32 outputs (RMSNorm rstd, flash LSE)
SCAN_TOL = 1e-5                  # tests/test_kernels.py's selective-scan tolerance
SFU_PER_CLOCK = 16               # exponentials a clock on each SM (Hopper)
# gradients: of the largest magnitude of the plain version's gradient
GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the ABFT product: each element within 32 float32 ulps of its absolute
# mass (|A_ext| @ |B_ext|), which a float32 sum's rounding error scales
# with.  A TF32 product, an output through bf16 or a dropped K tile lands
# 10-1000x above it (checked every run, below).
ABFT_TOL = 32 * 2.0 ** -24
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
# train-ssm: falcon-mamba-7b at full width, depth cut to 2 layers (64
# layers of float32 weights and AdamW moments come to ~117 GB; 4 until PR
# 27, cut for this script's time limit when the families' training came:
# its raw saves and restores took 57 s of a middling host's run, PERF.md
# §4), the train phase's batch, steps, saves and fail-stop
SSM_TRAIN_LAYERS = 2
# serve-ssm: falcon-mamba-7b at full width and 32 of its 64 layers (64
# until PR 27, cut for this script's time limit: PERF.md §4)
SSM_SERVE_LAYERS = 32
# the fwi phase: the extent of the Marmousi model (9.2 km x 3.0 km;
# Versteeg 1994, The Leading Edge 13(9)) at the reference's physics (dx
# 10 m, dt 1 ms, 12 Hz Ricker): nz 300, nx 920, nt 2000 (a 2 s record;
# CFL 3200 * 1e-3 / 10 = 0.32).  16 shots (the paper spread 50 over 32
# cores: cut to 16 for this script's time limit) in 2 groups of 8 (an
# iteration's autograd record keeps nz * nx * 4 B a step a shot, 2.2 GB
# a shot), 3 iterations a run, a fail-stop at iteration 2 in local scope
# over 4 shot shards, 2 timed runs a configuration for eq. 2 (3 until PR
# 27: cut for this script's time limit, PERF.md §4; a host-bound
# iteration takes 2.3-3.2 s)
FWI_SIZE = dict(nz=300, nx=920, nt=2000, n_shots=16)
FWI_GROUP = 8
FWI_ITERS = 3
FWI_FAIL = 2
FWI_WIDTH = 4
FWI_RUNS = 2
# tiny-fwi: tests/test_torch_fwi.py's size and its trajectory tolerance
TINY_FWI = dict(nz=50, nx=50, nt=300, n_shots=2, iterations=6)
PAGE_SIZE = 16
PROMPT_LENS = (128, 200, 256)
GEN = 32
MAX_LEN = max(PROMPT_LENS) + GEN                     # 288 = 18 pages
MAX_ACTIVE = 8
KILL_STEP = 5
# serve-standby: granite-3-8b at 8 of its 40 layers (its raw save and
# restore of 16.4 GB at 40 layers took 42.6 s of the whole script on a
# slow host, PERF.md §4: the cut keeps the script inside its limit)
STANDBY_LAYERS = 8
# the other families (tiny-families, serve-families): recurrentgemma-2b's
# long prompt, past its window of 2048; phi3.5-moe and qwen1.5-110b cut to
# 4 layers (32 layers of phi3.5-moe need ~84 GB of bf16 weights, 80 of
# qwen1.5-110b ~222 GB), 16 new tokens; qwen2-vl-2b's batch of 2: 64 text
# embeddings, a 24 x 24 patch grid, 16 text embeddings, then 16 decode
# steps; hubert-xlarge's 4 x 1000 frames (20 s at 50 Hz)
FAMILY_LONG_PROMPT = 2300
FAMILY_GEN = 16
FAMILY_CUT_LAYERS = 4
VL_TEXT, VL_GRID, VL_TAIL, VL_DECODE = 64, 24, 16, 16
HUBERT_BATCH, HUBERT_FRAMES = 4, 1000
# qwen2-vl-2b's bf16 decode against a full forward, of the largest
# magnitude: the readings are 2.0-2.7 % over 28 layers, with the plain
# attention on both sides too, and granite-3-8b's 28 layers over token
# ids drift 1.6-1.9 % (PERF.md §7, scripts/decode_gap.py); the limit
# keeps about twice that, so a gross bf16-only fault still fails
VL_BF16_DECODE_TOL = 5e-2
# the steps phases: the decode step's device ms in these kernel groups
# (launch/profile_steps.GROUPS), beside the readings of the tree before
# the redesign of the paged-attention kernel and the RMSNorm forward
# (commit 0aafc35: one block a (row, kv head) walking its pages, a
# two-pass RMSNorm), taken by its launch/profile_steps.py in the same
# chip run as this tree's chip_smoke.py (H100 80GB HBM3, 700.00 W;
# PERF.md §5)
STEP_GROUPS = ("paged_attention", "rmsnorm")
STEP_GROUPS_BEFORE = {
    "steps": {"paged_attention": 1.5175, "rmsnorm": 0.2187},
    "steps-ssm": {"paged_attention": 0.0, "rmsnorm": 0.1811}}
# the depth those readings were taken at (serve-ssm's 64 layers then)
STEPS_BEFORE_LAYERS = {"steps": 40, "steps-ssm": 64}
# steps-ssm: the 200-token falcon-mamba-7b prefill's device ms in its 64
# selective_scan launches on the tree before the scan's redesign (commit
# 009490d), read by its launch/profile_steps.py in the same chip run as
# this tree's chip_smoke.py (H100 80GB HBM3, 700.00 W; PERF.md §6)
PREFILL_SCAN_BEFORE = 2.1098

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
    "block_hash": ("csrc/block_hash.cu",
                   "src/repro/kernels/block_hash/kernel.py:59"),
    "abft_matmul": ("csrc/abft_matmul.cu",
                    "src/repro/kernels/abft_matmul/kernel.py:36"),
    "selective_scan": ("csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan/kernel.py:52"),
    # the TPU scan has no backward: this supplies the gradient of the one
    # above
    "selective_scan_bwd": ("csrc/selective_scan_bwd.cu",
                           "src/repro/kernels/selective_scan/kernel.py:52"),
}


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``t_s``)."""
    if "phase" in obj:
        obj = dict(obj, t_s=round(time.perf_counter() - _T0, 1))
    print(json.dumps(obj), flush=True)


def peaks(name: str):
    """The card's part and its published peaks (dense, NVIDIA data sheets;
    ``launch/roofline.py``'s table): (part, (bytes/s, bf16 FLOP/s,
    float32 FLOP/s on the CUDA cores))."""
    from repro_torch.launch.roofline import PARTS, part_of

    key = part_of(name)
    hw = PARTS[key]
    return key, (hw["hbm_bw"], hw["peak_flops"], hw["fp32_flops"])


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


def _kernel_name(name: str) -> str:
    """A profiler's kernel name without its namespace, return type and
    argument list: ``abft_wgmma<true, true, true>``."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name[5:] if name.startswith("void ") else name


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
    peak_name, (bw, flops, fp32_flops) = peaks(name)
    emit({"phase": "card", "device": name, "count":
          torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "peaks": {"part": peak_name, "bytes_per_s": bw,
                    "bf16_flop_per_s": flops,
                    "fp32_flop_per_s": fp32_flops}})
    return name, smi, bw, flops, fp32_flops


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT))})


def _no_pdl(measure, fn):
    """``measure(fn)`` with programmatic dependent launch off."""
    from repro_torch.kernels import build

    build.set_pdl(False)
    try:
        return measure(fn)
    finally:
        build.set_pdl(True)


def _rmsnorm_cases(gen, bw):
    from repro_torch.kernels.rmsnorm.kernel import rms_norm_2d
    from repro_torch.kernels.rmsnorm.ref import rms_norm_ref

    D = 4096
    w = (1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")
         ).to(torch.bfloat16)
    # the latency floor of the harness: a one-element zero_, captured and
    # replayed as the kernel is
    one = torch.empty(1, device="cuda")
    floor_ms = time_ms(one.zero_)
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
        kernel_ms = time_ms(lambda: rms_norm_2d(x, w, rstd=rstd))
        bound_ms = (T * D * 4 + D * 2 + (T * 4 if rstd is not None
                                         else 0)) / bw * 1e3
        out.append({
            "shape": f"({T}, {D}) bf16" + (" rstd" if rstd is not None
                                           else ""),
            "main": T == MAX_ACTIVE, "max_abs_err": err,
            "tol": BF16_TOL if rstd is None else
            {"y": BF16_TOL, "rstd": FP32_TOL},
            "kernel_ms": kernel_ms,
            "kernel_ms_no_pdl": _no_pdl(
                time_ms, lambda: rms_norm_2d(x, w, rstd=rstd)),
            "floor_ms": floor_ms, "share_of_floor": floor_ms / kernel_ms,
            "share_of_bound": bound_ms / kernel_ms,
            "plain_ms": time_ms(lambda: rms_norm_ref(x, w)),
            "library_ms": time_ms(lambda: torch.nn.functional.rms_norm(
                x, (D,), w, eps=1e-6)),
            "bound_ms": bound_ms, "bound_by": "bytes"})
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

    B_train = TRAIN_BATCH // TRAIN_MICRO
    # (B, S, H, K, hd, causal, window, softcap).  granite's 32/8 heads of
    # 128: S = MAX_LEN is the serve path's (padded) prefill length, 300 is
    # ragged; the train path calls it a microbatch at a time with the LSE
    # (B_train, TRAIN_SEQ), here also with a window and a softcap.  Then
    # the other families' prefills: gemma-7b's 16 heads of 256 at the
    # serve length, recurrentgemma-2b's LOCAL layers (16 padded q heads of
    # 256 over one kv head, window 2048) at the long prompt, and
    # hubert-xlarge's encoder (16 heads of 80, non-causal) at its batch.
    cases = [(1, S, 32, 8, 128, True, w, c)
             for S, w, c in ((128, 0, 0.0), (MAX_LEN, 0, 0.0), (300, 0, 0.0),
                             (512, 0, 0.0), (512, 64, 30.0))]
    cases += [(B_train, TRAIN_SEQ, 32, 8, 128, True, w, c)
              for w, c in ((0, 0.0), (512, 30.0))]
    cases += [(1, MAX_LEN, 16, 16, 256, True, 0, 0.0),
              (1, FAMILY_LONG_PROMPT, 16, 1, 256, True, 2048, 0.0),
              (HUBERT_BATCH, HUBERT_FRAMES, 16, 16, 80, False, 0, 0.0)]
    out = []
    for B, S, H, K, hd, causal, window, softcap in cases:
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device="cuda"
                               ).to(torch.bfloat16) for n in (H, K, K))
        kw = dict(causal=causal, window=window, softcap=softcap)
        train = S == TRAIN_SEQ
        label = (f"flash B={B} S={S} H={H} K={K} hd={hd} causal={causal} "
                 f"window={window} softcap={softcap}")
        if train:
            o, lse = flash_attention_bshd(q, k, v, lse=True, **kw)
            err = max(check_close(label, o, flash_attention_ref(q, k, v, **kw),
                                  BF16_TOL),
                      check_close(label + " lse", lse,
                                  _plain_lse(q, k, **kw), FP32_TOL))
            o2, lse2 = flash_attention_bshd(q, k, v, lse=True, **kw)
            same = torch.equal(o, o2) and torch.equal(lse, lse2)
            del o, lse, o2, lse2
        else:
            o = flash_attention_bshd(q, k, v, **kw)
            err = check_close(label, o, flash_attention_ref(q, k, v, **kw),
                              BF16_TOL)
            same = torch.equal(o, flash_attention_bshd(q, k, v, **kw))
            del o
        if not same:
            raise AssertionError(f"{label}: two calls differ")
        kw_t = dict(iters=3, reps=3) if train or S * B >= 2048 else {}
        # One SDPA call computes the same function unless a softcap is set:
        # a window goes in as a boolean (S, S) mask, built outside the
        # timed call.  The library's output is held to the plain version
        # too, so the time is that of the same function.
        library_ms = library_err = None
        if not softcap:
            from repro_torch.layers.attention import _mask

            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            pos = torch.arange(S, device="cuda")
            sdpa_kw = (dict(attn_mask=_mask(pos, pos, causal=causal,
                                            window=window))
                       if window else dict(is_causal=causal))

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=True, **sdpa_kw)

            library_err = check_close(
                label + " sdpa", library().transpose(1, 2),
                flash_attention_ref(q, k, v, **kw), BF16_TOL)
            library_ms = time_ms(library, **kw_t)
        ops = 4 * B * H * hd * _attended_pairs(S, causal, window)
        op_s = ops / flops
        byte_s = (2 * B * (2 * S * H * hd + 2 * S * K * hd)
                  + (B * H * S * 4 if train else 0)) / bw
        kernel_ms = time_ms(
            lambda: flash_attention_bshd(q, k, v, lse=train, **kw), **kw_t)
        out.append({
            "shape": f"q ({B}, {S}, {H}, {hd}) kv ({B}, {S}, {K}, {hd}) "
                     f"bf16 {'causal' if causal else 'bidirectional'} "
                     f"window={window} softcap={softcap}"
                     + (" lse" if train else ""),
            "main": S == MAX_LEN and not window and hd == 128,
            "head_dim": hd, "max_abs_err": err,
            "tol": {"o": BF16_TOL, "lse": FP32_TOL} if train else BF16_TOL,
            "kernel_ms": kernel_ms,
            "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, **kw),
                                **kw_t),
            "library_ms": library_ms, "library_max_abs_err": library_err,
            "bound_ms": max(op_s, byte_s) * 1e3,
            "bound_by": "operations" if op_s >= byte_s else "bytes",
            "tflops": ops / kernel_ms / 1e9,
            "share_of_bound": max(op_s, byte_s) * 1e3 / kernel_ms})
        del q, k, v
    return out


def _paged_cases(gen, bw):
    from repro_torch.launch.profile_steps import LENGTHS

    ps = PAGE_SIZE
    # (K, G, hd, lengths, windows): granite's decode (8 rows, 32/8 heads
    # of 128: an inactive row (0, zeroed table), page boundaries, a full
    # table), gemma-7b's (16 kv heads of 256, G 1) and recurrentgemma-2b's
    # LOCAL layers over its 4 slot rows (16 padded q heads of 256 over one
    # kv head: G hd 4096, past one block's group; lengths up to the long
    # prompt's, window 2048)
    long_len = FAMILY_LONG_PROMPT + GEN - 1
    groups = ((8, 4, 128, list(LENGTHS), ((0, 0.0), (64, 30.0))),
              (16, 1, 256, list(LENGTHS), ((0, 0.0),)),
              (1, 16, 256, [long_len, 1500, 290, 140], ((2048, 0.0),)))
    out = []
    for K, G, hd, lengths, windows in groups:
        out += _paged_group(gen, bw, ps, K, G, hd, lengths, windows)
    return out


def _paged_group(gen, bw, ps, K, G, hd, lengths, windows):
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_rhd
    from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                         split_positions)
    from repro_torch.launch.profile_steps import profile_step

    R = len(lengths)
    mpr = -(-(max(lengths) + 1) // ps)
    P = R * mpr + 1
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    table = torch.zeros(R, mpr, dtype=torch.int32, device="cuda")
    for r, n in enumerate(lengths):
        if n == 0:
            continue
        used = n // ps + 1
        table[r, :used] = perm[r * mpr:r * mpr + used].to(torch.int32)
    # the same rows through a table of 22 more entries
    wide = torch.zeros(R, mpr + 22, dtype=torch.int32, device="cuda")
    wide[:, :mpr] = table
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn(R, K * G, hd, generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    kp, vp = (torch.randn(P, ps, K, hd, generator=gen, device="cuda"
                          ).to(torch.bfloat16) for _ in range(2))
    C = split_positions(hd, q.dtype)
    out = []
    for window, softcap in windows:
        kw = dict(window=window, softcap=softcap)

        def kernel():
            return paged_attention_rhd(q, kp, vp, table, lens, **kw)

        def plain():
            return paged_attention_ref(q[:, None], kp, vp, table, lens,
                                       **kw)[:, 0]

        got = kernel()
        err = check_close(f"paged window={window} softcap={softcap}", got,
                          plain(), BF16_TOL)
        if not torch.equal(kernel(), got):
            raise AssertionError(f"paged window={window}: two calls differ")
        if not torch.equal(paged_attention_rhd(q, kp, vp, wide, lens, **kw),
                           got):
            raise AssertionError(f"paged window={window}: a {mpr + 22}-entry "
                                 f"table changed the bits of the "
                                 f"{mpr}-entry one")
        kv_bytes = sum(min(n + 1, window) if window else n + 1
                       for n in lengths) * K * hd * 2 * 2
        io_bytes = 2 * R * K * G * hd * 2 + R * mpr * 4 + R * 4
        bound_ms = (kv_bytes + io_bytes) / bw * 1e3
        kernel_ms = time_ms(kernel)
        # device ms of each kernel of one call (split pass, combine),
        # profiled eagerly without programmatic dependent launch (with it a
        # kernel's span includes its wait for the kernel before it)
        split = _no_pdl(lambda f: profile_step(f, calls=5), kernel)[
            "top_kernels_ms"]
        out.append({
            "shape": f"R={R} K={K} G={G} hd={hd} ps={ps} MPR={mpr} bf16 "
                     f"lengths={lengths} window={window} softcap={softcap}",
            "main": not window and hd == 128, "group_width": G * hd,
            "max_abs_err": err, "tol": BF16_TOL,
            "split_positions": C, "repeat_bit_equal": True,
            "wider_table_bit_equal": True,
            "kernel_ms": kernel_ms,
            "kernel_ms_no_pdl": _no_pdl(time_ms, kernel),
            "kernels_ms": {_kernel_name(n): ms for n, ms in split.items()},
            "share_of_bound": bound_ms / kernel_ms,
            "plain_ms": time_ms(plain), "library_ms": None,
            "bound_ms": bound_ms, "bound_by": "bytes"})
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
    from repro_torch.launch.profile_steps import profile_step

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
        dx2, dw2 = rms_norm_2d_bwd(g, x, w, rstd)
        if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
            raise AssertionError(f"rmsnorm_bwd {dtype}: two launches differ")
        leaves = (x.clone().requires_grad_(), w.clone().requires_grad_())
        gx, gw = _grads(rms_norm_ref, leaves, g)
        tol = GRAD_TOL[dtype]
        err = max(check_grad(f"rmsnorm_bwd dx {dtype}", dx, gx, tol),
                  check_grad(f"rmsnorm_bwd dw {dtype}", dw, gw, tol))

        def library(xl, wl):
            return torch.nn.functional.rms_norm(xl, (D,), wl, eps=1e-6)

        es = x.element_size()
        kernel_ms = time_ms(lambda: rms_norm_2d_bwd(g, x, w, rstd))
        bound_ms = ((3 * R * D + 2 * D) * es + R * 4) / bw * 1e3
        # device ms of each kernel of one call (the fused pass, the reduce
        # of the dw partials), profiled eagerly
        split = profile_step(lambda: rms_norm_2d_bwd(g, x, w, rstd),
                             calls=5)["top_kernels_ms"]
        out.append({
            "shape": f"({R}, {D}) {str(dtype).split('.')[-1]}",
            "main": dtype == torch.bfloat16, "max_abs_err": err, "tol": tol,
            "repeat_bit_equal": True,
            "kernel_ms": kernel_ms,
            "kernels_ms": {_kernel_name(n): ms for n, ms in split.items()},
            "share_of_bound": bound_ms / kernel_ms,
            "plain_ms": _bwd_ms(rms_norm_ref, leaves, g),
            "library_ms": _bwd_ms(library, leaves, g),
            "bound_ms": bound_ms, "bound_by": "bytes"})
        del x, g, w, leaves, gx, gw, dx, dw, dx2, dw2
    return out


def _flash_bwd_usage():
    """Registers, spills and stack frame of every backward instantiation
    (``flash_bwd_dkdv_wgmma<tile width, head width>``, the float32
    ``flash_bwd_dkdv<float, head width>``, ...) from the build's
    ``-Xptxas -v`` log."""
    import re

    from repro_torch.kernels import build

    out = {}
    for name, use in build.ptxas_usage("flash_attention_bwd").items():
        m = re.search(r"\d(flash_bwd_[a-z_]+?)I([fL].*?)EEv", name)
        if m:
            args = re.findall(r"Li(\d+)", m.group(2))
            typ = ["float"] if m.group(2).startswith("f") else []
            out[f"{m.group(1)}<{', '.join(typ + args)}>"] = use
    return out


# the backward's cases: (B, S, H, K, hd, causal, window, softcap, dtype).
# A train microbatch of granite-3-8b (32/8 heads of 128) in bf16 and
# float32, with a window and a softcap; then the new families' train
# shapes: gemma-7b's microbatch (16/16 heads of 256), recurrentgemma-2b's
# (16 padded q heads over one kv head of 256, window 2048, S 4096) and
# hubert-xlarge's (16/16 heads of 80, non-causal), each in bf16 and in
# float32 at a smaller B
FLASH_BWD_CASES = [
    (2, TRAIN_SEQ, 32, 8, 128, True, 0, 0.0, torch.bfloat16),
    (2, TRAIN_SEQ, 32, 8, 128, True, 0, 0.0, torch.float32),
    (2, TRAIN_SEQ, 32, 8, 128, True, 512, 30.0, torch.bfloat16),
    (2, TRAIN_SEQ, 16, 16, 256, True, 0, 0.0, torch.bfloat16),
    (1, TRAIN_SEQ, 16, 16, 256, True, 0, 0.0, torch.float32),
    (1, 2 * TRAIN_SEQ, 16, 1, 256, True, 2048, 0.0, torch.bfloat16),
    (1, 2 * TRAIN_SEQ, 16, 1, 256, True, 2048, 0.0, torch.float32),
    (HUBERT_BATCH, HUBERT_FRAMES, 16, 16, 80, False, 0, 0.0,
     torch.bfloat16),
    (HUBERT_BATCH // 2, HUBERT_FRAMES, 16, 16, 80, False, 0, 0.0,
     torch.float32),
]


def _flash_bwd_cases(gen, bw, flops, fp32_flops):
    """The backward at FLASH_BWD_CASES' shapes against autograd of the
    plain version on the same inputs, two launches bit-equal, with SDPA's
    backward on the same inputs beside it where one call computes the
    same function (no softcap; a window as a boolean (S, S) mask)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bshd, flash_attention_bshd_bwd)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch.profile_steps import profile_step
    from repro_torch.layers.attention import _mask

    out = []
    for B, S, H, K, hd, causal, window, softcap, dtype in FLASH_BWD_CASES:
        q, do = (torch.randn(B, S, H, hd, generator=gen, device="cuda"
                             ).to(dtype) for _ in range(2))
        k, v = (torch.randn(B, S, K, hd, generator=gen, device="cuda"
                            ).to(dtype) for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=softcap)
        label = (f"flash_bwd B={B} S={S} H={H} K={K} hd={hd} "
                 f"{str(dtype).split('.')[-1]} causal={causal} "
                 f"window={window} softcap={softcap}")
        o, lse = flash_attention_bshd(q, k, v, lse=True, **kw)
        got = flash_attention_bshd_bwd(q, k, v, o, do, lse, **kw)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        def plain(qq, kk, vv):
            return flash_attention_ref(qq, kk, vv, **kw)

        want = _grads(plain, leaves, do)
        tol = GRAD_TOL[dtype]
        err = max(check_grad(f"{label} {n}", a, b, tol)
                  for n, a, b in zip(("dq", "dk", "dv"), got, want))
        del want
        again = flash_attention_bshd_bwd(q, k, v, o, do, lse, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{label}: two launches differ")
        del again
        library_ms = None
        if not softcap:
            lib = [t.transpose(1, 2).clone().requires_grad_()
                   for t in (q, k, v)]
            pos = torch.arange(S, device="cuda")
            sdpa_kw = (dict(attn_mask=_mask(pos, pos, causal=causal,
                                            window=window))
                       if window else dict(is_causal=causal))

            def sdpa(qq, kk, vv):
                return torch.nn.functional.scaled_dot_product_attention(
                    qq, kk, vv, enable_gqa=True, **sdpa_kw)

            library_ms = _bwd_ms(sdpa, lib, do.transpose(1, 2).contiguous(),
                                 iters=3, reps=3)
            del lib
        pairs = _attended_pairs(S, causal, window)
        peak = flops if dtype == torch.bfloat16 else fp32_flops
        ops = 10 * hd * pairs * H * B
        op_s = ops / peak
        es = q.element_size()
        byte_s = ((4 * B * S * H * hd + 4 * B * S * K * hd) * es
                  + B * H * S * 4) / bw
        kernel_ms = time_ms(
            lambda: flash_attention_bshd_bwd(q, k, v, o, do, lse, **kw),
            iters=3, reps=3)
        # device ms of each kernel of one call (the bf16 path launches a
        # prep kernel and the dK/dV and dQ passes)
        split = profile_step(
            lambda: flash_attention_bshd_bwd(q, k, v, o, do, lse, **kw),
            calls=3)["top_kernels_ms"]
        out.append({
            "shape": f"q (B={B}, {S}, {H}, {hd}) kv ({S}, {K}, {hd}) "
                     f"{str(dtype).split('.')[-1]} "
                     f"{'causal' if causal else 'bidirectional'} "
                     f"window={window} softcap={softcap}",
            "main": (dtype == torch.bfloat16 and hd == 128
                     and not window),
            "head_dim": hd, "max_abs_err": err, "tol": tol,
            "repeat_bit_equal": True, "kernel_ms": kernel_ms,
            "kernels_ms": {_kernel_name(n): ms for n, ms in split.items()},
            "plain_ms": _bwd_ms(plain, leaves, do, iters=3, reps=3),
            "library_ms": library_ms,
            "gflop": ops / 1e9,
            "bound_ms": max(op_s, byte_s) * 1e3,
            "bound_by": "operations" if op_s >= byte_s else "bytes",
            "tflops": ops / kernel_ms / 1e9,
            "share_of_bound": max(op_s, byte_s) * 1e3 / kernel_ms})
        del q, k, v, do, o, lse, got, leaves
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "name": "flash_attention_bwd",
          "ptxas": _flash_bwd_usage()})
    return out


def _hash_check(label, leaves, block):
    """One grouped launch over ``leaves``, bit-equal to the plain version
    leaf by leaf."""
    from repro_torch.kernels.block_hash.kernel import hash_leaves
    from repro_torch.kernels.block_hash.ref import block_hashes_ref

    h, spans = hash_leaves(leaves, block)
    for x, (start, n) in zip(leaves, spans):
        if not torch.equal(h[start:start + n], block_hashes_ref(x, block)):
            raise AssertionError(f"block_hash {label}: a {x.dtype} leaf of "
                                 f"{tuple(x.shape)} differs from the plain "
                                 f"version at block size {block}")


def _block_hash_cases(gen, bw, seed):
    """The embed leaf (main), leaves of every element size, a ragged leaf
    at two block sizes, and one grouped launch over the full-width train
    state (TRAIN_LAYERS layers), each bit-equal to the plain version."""
    from repro_torch.kernels.block_hash.kernel import hash_leaves
    from repro_torch.kernels.block_hash.ref import block_hashes_ref
    from repro_torch.models import get_config
    from repro_torch.train import init_state
    from repro_torch.tree import leaves as tree_leaves

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    cases = [("embed (51200, 4096) fp32", [randn(51200, 4096)], 65536),
             ("(4096, 4096) bf16", [randn(4096, 4096).to(torch.bfloat16)],
              65536),
             ("(1048593,) int8", [(randn(1 << 20 | 17) * 50).to(torch.int8)],
              65536),
             ("(300001,) int64", [(randn(300001) * 1e9).to(torch.int64)],
              65536),
             ("(300001,) fp64 (8-byte split)",
              [randn(300001).to(torch.float64)], 65536),
             ("(4095, 4097) fp32 ragged, block 256", [randn(4095, 4097)],
              256),
             ("(4095, 4097) fp32 ragged, block 65536", [randn(4095, 4097)],
              65536)]
    out = []
    for label, leaves, block in cases:
        _hash_check(label, leaves, block)
        n_bytes = sum(x.numel() * x.element_size() for x in leaves)
        n_blocks = sum(-(-x.numel() // block) for x in leaves)
        out.append({
            "shape": label, "main": label.startswith("embed"),
            "max_abs_err": 0.0, "tol": "bit-equal",
            "kernel_ms": time_ms(lambda: hash_leaves(leaves, block),
                                 iters=5, reps=5),
            "plain_ms": time_ms(lambda: [block_hashes_ref(x, block)
                                         for x in leaves], iters=2, reps=3),
            "library_ms": None,
            "bound_ms": (n_bytes + 4 * n_blocks) / bw * 1e3,
            "bound_by": "bytes"})
        del leaves
    torch.cuda.empty_cache()
    # the grouped launch of a save or a scrub: every leaf of the state
    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              num_layers=TRAIN_LAYERS)
    state = tree_leaves(init_state(cfg, seed=seed, device="cuda"))
    before = hash_leaves.launches
    _hash_check("full-width train state", state, 65536)
    if hash_leaves.launches != before + 1:
        raise AssertionError("the train state took more than one launch")
    n_bytes = sum(x.numel() * x.element_size() for x in state)
    n_blocks = sum(-(-x.numel() // 65536) for x in state)
    out.append({
        "shape": f"train state, {len(state)} leaves, {n_bytes} bytes, "
                 f"{n_blocks} blocks", "main": False, "max_abs_err": 0.0,
        "tol": "bit-equal",
        "kernel_ms": time_ms(lambda: hash_leaves(state, 65536), iters=2,
                             reps=3),
        "plain_ms": None, "library_ms": None,
        "bound_ms": (n_bytes + 4 * n_blocks) / bw * 1e3,
        "bound_by": "bytes"})
    del state
    torch.cuda.empty_cache()
    return out


def _abft_checks(label, a, b, c_full):
    """The verifier on the kernel's product: clean is clean; one data
    element is located and corrected (every other element untouched, the
    corrected one within the residual tolerance); a checksum hit leaves
    the data intact; two errors are detected and not corrected."""
    from repro_torch.kernels.abft_matmul.ops import (abft_matmul,
                                                     verify_and_correct)

    M, N = a.shape[0], b.shape[1]
    clean, rep = abft_matmul(a, b)
    if bool(rep["detected"]):
        raise AssertionError(f"abft {label}: a clean product was flagged "
                             f"({int(rep['bad_rows'])} rows, "
                             f"{int(rep['bad_cols'])} columns)")
    if not torch.equal(clean, c_full[:-1, :-1]):
        raise AssertionError(f"abft {label}: two launches differ")
    delta = 100.0 * clean.abs().max().item()
    i, j = M // 3, N // 2
    c, rep = abft_matmul(a, b, inject=(i, j, delta))
    if not (bool(rep["detected"]) and bool(rep["corrected"])
            and (int(rep["row"]), int(rep["col"])) == (i, j)):
        got = {k: v.item() for k, v in rep.items()}
        raise AssertionError(f"abft {label}: a data error at {(i, j)} was "
                             f"not located: {got}")
    diff = (c - clean).abs()
    tol = 1e-5 + 1e-4 * (clean[i].abs().sum() + c_full[i, -1].abs()
                         + clean[:, j].abs().sum() + c_full[-1, j].abs())
    if diff[i, j] > tol or diff.sum() != diff[i, j]:
        raise AssertionError(f"abft {label}: the corrected C differs from "
                             f"the clean C beyond the element's tolerance")
    for hit in ((M, j, delta), (i, N, delta)):
        c, rep = abft_matmul(a, b, inject=hit)
        if not (bool(rep["detected"]) and bool(rep["corrected"])
                and torch.equal(c, clean)):
            raise AssertionError(f"abft {label}: a checksum hit at "
                                 f"{hit[:2]} touched the data")
    two = c_full.clone()
    two[i, j] += delta
    two[(i + 7) % M, (j + 11) % N] -= delta
    _, rep = verify_and_correct(two)
    if not bool(rep["detected"]) or bool(rep["corrected"]):
        raise AssertionError(f"abft {label}: two errors were not detected "
                             "as uncorrectable")
    return diff.max().item()


def _mass_ratio(got, want, mass) -> float:
    """max |got - want| / mass over the extended product."""
    return ((got - want).abs() / mass).max().item()


def _abft_cases(gen, bw, flops, fp32_flops):
    """One microbatch's MLP ``w_in`` (x @ w, M = 2048 tokens, K = 4096,
    N = 12800, bf16 operands) and its two backward contractions, dx = g @
    w^T and dw = x^T @ g with a float32 g, read through transposed views:
    the route the wrapper takes (the tensor cores for all three), two
    launches bit-equal, every element of C (data, checksum row and column)
    within ABFT_TOL of its absolute mass of the plain version (float32
    matmul of the extended operands), and three wrong products outside it:
    TF32 (in the checksum row and column even where bf16 operands make the
    data exact), the plain C through bf16, and the product without its
    last 32 K terms.  The kept CUDA-core SGEMM beside it: its reading and
    its time on the same operands.  Then the library call (one
    ``torch.matmul`` of the same extended operands, TF32 off) and the
    verifier's checks.  The bound
    counts the bf16 tensor-core passes the exact split needs (one for bf16
    x bf16, three with a float32 operand); the float32 CUDA-core bound of
    the same product stands beside it."""
    from repro_torch.kernels.abft_matmul import kernel as abft_kernel
    from repro_torch.kernels.abft_matmul.kernel import abft_matmul_ext
    from repro_torch.kernels.abft_matmul.ref import (abft_matmul_ref,
                                                     checksums, encode_ref,
                                                     product_mass)
    from repro_torch.launch.profile_steps import profile_step

    T, D, F = TRAIN_SEQ, 4096, 12800
    x = torch.randn(T, D, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(D, F, generator=gen, device="cuda")
         * D ** -0.5).to(torch.bfloat16)
    g = torch.randn(T, F, generator=gen, device="cuda") * 1e-3
    out = []
    for label, a, b in (("x @ w_in (2048, 4096) x (4096, 12800) bf16", x, w),
                        ("g @ w_in^T (2048, 12800) f32 x (12800, 4096) "
                         "bf16 col-major", g, w.t()),
                        ("x^T @ g (4096, 2048) bf16 col-major x "
                         "(2048, 12800) f32", x.t(), g)):
        a_sum, b_sum = checksums(a, b)
        route = abft_kernel.tc_route(a, b)
        tc_before = abft_matmul_ext.tc_launches
        c_full = abft_matmul_ext(a, a_sum, b, b_sum)
        if not (route and abft_matmul_ext.tc_launches == tc_before + 1):
            raise AssertionError(f"abft {label}: the tensor-core route was "
                                 "not taken")
        if not torch.equal(c_full, abft_matmul_ext(a, a_sum, b, b_sum)):
            raise AssertionError(f"abft {label}: two launches differ")
        want = abft_matmul_ref(a, b)
        mass = product_mass(a, b)
        if not torch.isfinite(c_full).all() or c_full.shape != want.shape:
            raise AssertionError(f"abft {label}: shape "
                                 f"{tuple(c_full.shape)} or non-finite")
        ratio = _mass_ratio(c_full, want, mass)
        if not ratio <= ABFT_TOL:
            raise AssertionError(f"abft {label}: an element is "
                                 f"{ratio:.3g} of its mass off the plain "
                                 f"version, beyond {ABFT_TOL:.3g}")
        err = (c_full - want).abs().max().item()
        sgemm = abft_kernel._launch(a, a_sum, b, b_sum, route=False)
        sgemm_err = _mass_ratio(sgemm, want, mass)
        del sgemm
        a_ext, b_ext = encode_ref(a, b)
        M, K = a.shape
        N = b.shape[1]
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = a_ext @ b_ext
        torch.backends.cuda.matmul.allow_tf32 = False
        wrong = {"tf32": tf32,
                 "bf16_output": want.to(torch.bfloat16).float(),
                 "last_32_k_dropped": a_ext[:, :K - 32] @ b_ext[:K - 32]}
        controls = {k: _mass_ratio(v, want, mass) for k, v in wrong.items()}
        del tf32, wrong
        if not min(controls.values()) > ABFT_TOL:
            raise AssertionError(f"abft {label}: a wrong product passes "
                                 f"the check: {controls}")
        corr_err = _abft_checks(label, a, b, c_full)
        passes = 3 if torch.float32 in (a.dtype, b.dtype) else 1
        flop = 2 * (M + 1) * (N + 1) * K
        op_s = passes * flop / flops
        byte_s = ((M + 1) * K * a.element_size() + K * (N + 1)
                  * b.element_size() + (M + 1) * (N + 1) * 4) / bw
        kw = dict(iters=3, reps=3)
        kernel_ms = time_ms(lambda: abft_matmul_ext(a, a_sum, b, b_sum),
                            **kw)
        # device ms of each kernel of one call (the split of a float32
        # operand, the checksum pieces, the mainloop), profiled eagerly
        split = profile_step(lambda: abft_matmul_ext(a, a_sum, b, b_sum),
                             calls=3)["top_kernels_ms"]
        out.append({
            "shape": label, "main": a is x, "route": "tensor cores",
            "max_abs_err": err, "max_err_of_mass": ratio,
            "tol_of_mass": ABFT_TOL, "sgemm_err_of_mass": sgemm_err,
            "wrong_products_err_of_mass": controls,
            "corrected_element_err": corr_err, "repeat_bit_equal": True,
            "kernel_ms": kernel_ms,
            "kernels_ms": {_kernel_name(n): ms for n, ms in split.items()},
            "share_of_bound": max(op_s, byte_s) * 1e3 / kernel_ms,
            "sgemm_ms": time_ms(lambda: abft_kernel._launch(
                a, a_sum, b, b_sum, route=False), **kw),
            "tflops_fp32_equivalent": flop / kernel_ms / 1e9,
            "plain_ms": time_ms(lambda: abft_matmul_ref(a, b), **kw),
            "library_ms": time_ms(lambda: torch.matmul(a_ext, b_ext), **kw),
            "bound_ms": max(op_s, byte_s) * 1e3,
            "bound_by": "operations" if op_s >= byte_s else "bytes",
            "bound_note": f"bf16 tensor cores, exact split: {passes} "
                          f"pass(es)",
            "bound_fp32_ms": max(flop / fp32_flops, byte_s) * 1e3})
        del c_full, want, mass, a_ext, b_ext
        torch.cuda.empty_cache()
    return out


def sfu_rate() -> float:
    """Exponentials a second the card's special-function units can give:
    SFU_PER_CLOCK on each SM at the SM's maximum clock (nvidia-smi)."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * SFU_PER_CLOCK * float(mhz) * 1e6


def _scan_inputs(gen, B, S, Di, N, h0_zero):
    """tests/test_kernels.py's draws: x, B, C ~ N(0, 1), dt =
    softplus(N(0, 1)) / 10, A = -exp(N(0, 1) / 5), h0 ~ N(0, 1) / 10."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = randn(B, S, Di)
    dt = torch.nn.functional.softplus(randn(B, S, Di)) * 0.1
    bm, cm = randn(B, S, N), randn(B, S, N)
    a = -torch.exp(randn(Di, N) * 0.2)
    h0 = randn(B, Di, N) * 0.1
    if h0_zero:
        h0 = torch.zeros_like(h0)
    return x, dt, bm, cm, a, h0


def _scan_usage():
    """Registers and spills of the scan's instantiations
    (``selective_scan_kernel<states a part, TMA route>``) from the
    build's ``-Xptxas -v`` log, and its dynamic shared memory from the
    library."""
    import re

    from repro_torch.kernels import build

    lib = build.library()
    lib.repro_selective_scan_smem.restype = ctypes.c_int
    out = {}
    for name, use in build.ptxas_usage("selective_scan").items():
        m = re.search(r"selective_scan_kernelI((?:L[a-z]\d+E)+)E", name)
        if m:
            args = ",".join(re.findall(r"L[a-z](\d+)E", m.group(1)))
            out[f"selective_scan_kernel<{args}>"] = use
    return {"kernels": out, "dynamic_smem": lib.repro_selective_scan_smem()}


def _scan_cases(gen, bw, fp32_flops, sfu):
    from repro_torch.kernels.selective_scan.kernel import \
        selective_scan_kernel
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    out = []
    # the serve path's prefill (B 1, S 256, falcon-mamba-7b's Di and N)
    # with a fresh and a carried state, a ragged S, two rows, the tiny N,
    # and a ragged Di (the 4-byte-copy route)
    for B, S, Di, N, h0_zero in ((1, 256, 8192, 16, True),
                                 (1, 256, 8192, 16, False),
                                 (1, 200, 8192, 16, False),
                                 (2, 256, 8192, 16, False),
                                 (1, 256, 128, 4, False),
                                 (1, 256, 8190, 16, False)):
        args = _scan_inputs(gen, B, S, Di, N, h0_zero)
        tma = selective_scan_kernel.tma_launches
        y, h = selective_scan_kernel(*args)
        route = ("tma" if selective_scan_kernel.tma_launches > tma
                 else "4-byte")
        if (route == "tma") != (Di % 4 == 0):
            raise AssertionError(f"selective_scan Di={Di} took the {route} "
                                 "route")
        yr, hr = selective_scan_ref(*args)
        label = f"selective_scan B={B} S={S} Di={Di} N={N}"
        err = max(check_close(label + " y", y, yr, SCAN_TOL),
                  check_close(label + " h_last", h, hr, SCAN_TOL))
        io_bytes = 4 * (3 * B * S * Di + 2 * B * S * N + Di * N
                        + 2 * B * Di * N)
        exps = B * S * Di * N
        # per (t, d, n): dt*A, the decay's multiply-add, dx*B, C*h summed;
        # per (t, d): dt*x
        flop = 6 * exps + B * S * Di
        by_ops = max(exps / sfu, flop / fp32_flops)
        by_bytes = io_bytes / bw
        kernel_ms = time_ms(lambda: selective_scan_kernel(*args))
        bound_ms = max(by_ops, by_bytes) * 1e3
        out.append({
            "shape": f"B={B} S={S} Di={Di} N={N} fp32 h0="
                     + ("0" if h0_zero else "random"),
            "main": (B, S, Di, N, h0_zero) == (1, 256, 8192, 16, True),
            "route": route, "max_abs_err": err, "tol": SCAN_TOL,
            "kernel_ms": kernel_ms,
            "plain_ms": time_ms(lambda: selective_scan_ref(*args), iters=2,
                                reps=3),
            "library_ms": None, "bound_ms": bound_ms,
            "bound_by": "operations" if by_ops > by_bytes else "bytes",
            "share_of_bound": bound_ms / kernel_ms,
            "bytes_ms": by_bytes * 1e3, "exp_ms": exps / sfu * 1e3,
            "fp32_ms": flop / fp32_flops * 1e3})
    emit({"phase": "kernel", "name": "selective_scan", "ptxas": _scan_usage()})
    return out


def _scan_bwd_usage():
    """Registers, spills, stack frame and static shared memory of the scan
    backward's kernels (``selective_scan_bwd_kernel<states a part, TMA
    route>`` and the reduce) from the build's ``-Xptxas -v`` log, and the
    main kernel's dynamic shared memory at N 16."""
    import re

    from repro_torch.kernels import build

    lib = build.library()
    lib.repro_selective_scan_bwd_smem.argtypes = [ctypes.c_int]
    lib.repro_selective_scan_bwd_smem.restype = ctypes.c_int
    out = {}
    for name, use in build.ptxas_usage("selective_scan_bwd").items():
        m = re.search(r"selective_scan_bwd_kernelI((?:L[a-z]\d+E)+)E", name)
        if m:
            args = ",".join(re.findall(r"L[a-z](\d+)E", m.group(1)))
            out[f"selective_scan_bwd_kernel<{args}>"] = use
        elif "selective_scan_bwd_reduce" in name:
            out["selective_scan_bwd_reduce"] = use
    return {"kernels": out,
            "dynamic_smem_n16": lib.repro_selective_scan_bwd_smem(16)}


def _scan_bwd_cases(gen, bw, fp32_flops, sfu):
    """The scan's backward kernel against the plain reverse scan
    (``ref.selective_scan_bwd_ref``) on the same inputs: every gradient
    within GRAD_TOL of its largest magnitude, two launches bit-equal, at
    one microbatch of train-ssm (B 2, S 2048, Di 8192, N 16, h0 = 0, no
    dh_last, B and C as column slices as the layer passes them; the TMA
    route) and at a ragged S and Di with a carried state and dh_last (the
    4-byte route).  Beside each time: the split of a call between the
    scan kernel and the reduce of its per-block sums (profiled), and the
    device scratch a call allocates."""
    from repro_torch.kernels.selective_scan import kernel as scan_kernel
    from repro_torch.kernels.selective_scan.kernel import \
        selective_scan_bwd_kernel
    from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_ref
    from repro_torch.launch.profile_steps import profile_step

    out = []
    for B, S, Di, N, carried in ((2, TRAIN_SEQ, 8192, 16, False),
                                 (1, 1000, 8190, 16, True)):
        x, dt, bm, cm, a, h0 = _scan_inputs(gen, B, S, Di, N,
                                            h0_zero=not carried)
        bcd = torch.cat([bm, cm], dim=-1)
        bm, cm = bcd[..., :N], bcd[..., N:]
        dy = torch.randn((B, S, Di), generator=gen, device="cuda")
        dh = (torch.randn((B, Di, N), generator=gen, device="cuda")
              if carried else None)
        args = (x, dt, bm, cm, a, h0, dy, dh)
        tma = selective_scan_bwd_kernel.tma_launches
        got = selective_scan_bwd_kernel(*args)
        route = ("tma" if selective_scan_bwd_kernel.tma_launches > tma
                 else "4-byte")
        if (route == "tma") != (Di % 4 == 0):
            raise AssertionError(f"selective_scan_bwd Di={Di} took the "
                                 f"{route} route")
        again = selective_scan_bwd_kernel(*args)
        label = f"selective_scan_bwd B={B} S={S} Di={Di} N={N}"
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            raise AssertionError(f"{label}: two launches differ")
        want = selective_scan_bwd_ref(*args)
        errs = {name: check_grad(f"{label} {name}", g, w,
                                 GRAD_TOL[torch.float32])
                for name, g, w in zip(("dx", "ddt", "dB", "dC", "dA", "dh0"),
                                      got, want)}
        del got, again, want
        io_bytes = 4 * (5 * B * S * Di + 4 * B * S * N + 2 * Di * N
                        + (3 if carried else 2) * B * Di * N)
        exps = B * S * Di * N
        # per (b, t, d, n): the state's recompute (dt*A, dx*B, a multiply-
        # add) and the reverse step (g, the four products of dC, dB, u and
        # q, dA's multiply-add, q*A, r, the sums over n and d)
        flop = 20 * exps
        by_ops = max(exps / sfu, flop / fp32_flops)
        by_bytes = io_bytes / bw
        kernel_ms = time_ms(lambda: selective_scan_bwd_kernel(*args),
                            iters=5, reps=5)
        # device ms of each kernel of one call (the scan, the reduce),
        # profiled eagerly
        split = profile_step(lambda: selective_scan_bwd_kernel(*args),
                             calls=3)["top_kernels_ms"]
        bound_ms = max(by_ops, by_bytes) * 1e3
        out.append({
            "shape": f"B={B} S={S} Di={Di} N={N} fp32 h0="
                     + ("random, dh_last random" if carried
                        else "0, no dh_last") + ", B/C column slices",
            "main": not carried, "route": route,
            "max_abs_err": max(errs.values()),
            "errors": errs, "tol": GRAD_TOL[torch.float32],
            "two_launches_bit_equal": True, "kernel_ms": kernel_ms,
            "kernels_ms": {_kernel_name(n): ms for n, ms in split.items()},
            "scratch_bytes": scan_kernel.scratch_bytes(B, S, Di, N),
            "plain_ms": time_ms(lambda: selective_scan_bwd_ref(*args),
                                iters=1, reps=2),
            "library_ms": None, "bound_ms": bound_ms,
            "bound_by": "operations" if by_ops > by_bytes else "bytes",
            "share_of_bound": bound_ms / kernel_ms,
            "bytes_ms": by_bytes * 1e3, "exp_ms": exps / sfu * 1e3,
            "fp32_ms": flop / fp32_flops * 1e3})
        del x, dt, bm, cm, bcd, a, h0, dy, dh, args
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "name": "selective_scan_bwd",
          "ptxas": _scan_bwd_usage()})
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
               "ckpt_quantize": quant, "ckpt_dequantize": dequant,
               "block_hash": _block_hash_cases(gen, bw, seed),
               "abft_matmul": _abft_cases(gen, bw, flops, fp32_flops),
               "selective_scan": _scan_cases(gen, bw, fp32_flops,
                                             sfu_rate()),
               "selective_scan_bwd": _scan_bwd_cases(gen, bw, fp32_flops,
                                                     sfu_rate())}
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
           replicas=2, max_len=MAX_LEN, slots=4, max_active=MAX_ACTIVE,
           injector=None, paged=None, standby=None,
           heartbeat_timeout_factor=10.0, **telemetry):
    """One engine run over ``prompts``; ``kill`` schedules the replica
    kill at ``KILL_STEP``, or ``injector`` brings its own schedule;
    ``paged=False`` serves from the slot pool (``slots`` rows a replica);
    ``standby`` (a params source) is registered as a warm standby;
    ``telemetry`` (``obs``, ``risk_source``, ``pre_drain_threshold``)
    goes to the engine as it is."""
    from repro_torch.core import FaultInjector
    from repro_torch.serve import ServeEngine

    if kill:
        injector = FaultInjector()
        injector.schedule_replica_kill(KILL_STEP, replica_id=replicas - 1)
    eng = ServeEngine(cfg, params, device=device, num_replicas=replicas,
                      slots_per_replica=slots, max_len=max_len,
                      max_active=max_active, page_size=PAGE_SIZE,
                      fault_tolerant=True, heartbeat_period=0.1,
                      heartbeat_timeout_factor=heartbeat_timeout_factor,
                      fault_injector=injector, paged=paged, **telemetry)
    if standby is not None:
        eng.add_standby(standby)
    try:
        rids = [eng.submit(p, gen_len) for p in prompts]
        t0 = time.perf_counter()
        results = eng.run()
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        reps = list(eng.router.replicas.values())
        if eng.paged:
            for rep in reps:
                ok, why = rep.pool.audit()
                if not ok:
                    raise AssertionError(f"replica {rep.id} pool audit: "
                                         f"{why}")
            cons = eng.page_conservation()
            if (cons["pages_free"] + cons["pages_held"]
                    != cons["pages_total"] or not cons["refs_ok"]):
                raise AssertionError(f"page conservation broken: {cons}")
        else:
            held = {rep.id: rep.pool.active_slots for rep in reps
                    if rep.pool.free_count != rep.pool.num_slots}
            if held:
                raise AssertionError(f"slots still held after the run: "
                                     f"{held}")
        failures = [e for e in eng.events if e["event"] == "replica_failed"]
        lat = eng.request_latencies()
        return {
            "rids": rids, "scheduler": eng.scheduler, "paged": eng.paged,
            "hosts": {rep.id: list(rep.hosts) for rep in reps},
            "predrained": [e for e in eng.events
                           if e["event"] == "replica_predrained"],
            "streams": [results.get(r) for r in rids],
            "dropped": len(eng.scheduler.failed_rids),
            "retried": len(eng.scheduler.retried_rids),
            "failures": failures, "wall": wall, "latencies": lat,
            "prefills": sum(r.prefills for r in reps),
            "decode_calls": sum(r.steps for r in reps),
            "prefix_hits": (sum(r.pool.prefix_hits for r in reps)
                            if eng.paged else 0),
            "entropy_ema": [r.sentinel.entropy_ema for r in reps
                            if r.sentinel is not None],
            "events": [e["event"] for e in eng.events],
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
    return got["streams"]


def phase_tiny_slots(seed: int, paged_streams):
    """``tiny-slots``: the tiny phase's engine and prompts served from the
    slot pool (4 rows, the paged run's 4 decode rows) on the card and on
    the CPU: the streams agree token for token, and equal the tiny
    phase's paged streams."""
    from repro_torch.models import get_config, init_params

    paged = _counters()["paged_attention"]
    cfg = dataclasses.replace(get_config("granite-3-8b", tiny=True),
                              dtype=torch.float32)
    cpu = init_params(cfg, seed=seed, device="cpu")
    gpu = _tree_to(cpu, "cuda")
    prompts = _prompts(cfg.vocab_size, seed, (16, 24, 32))
    kw = dict(replicas=1, max_len=48, slots=4, paged=False)
    want = _serve(cfg, cpu, prompts, 8, "cpu", **kw)
    paged.launches = 0
    got = _serve(cfg, gpu, prompts, 8, "cuda", **kw)
    if got["streams"] != want["streams"] or None in got["streams"]:
        raise AssertionError(f"tiny-slots: float32 streams differ between "
                             f"the card and the CPU:\n{got['streams']}\n"
                             f"{want['streams']}")
    if got["streams"] != paged_streams:
        raise AssertionError(f"tiny-slots: the slot pool's streams differ "
                             f"from the paged pool's:\n{got['streams']}\n"
                             f"{paged_streams}")
    if paged.launches != cfg.num_layers * got["decode_calls"]:
        raise AssertionError(f"tiny-slots: {paged.launches} paged launches "
                             f"for {got['decode_calls']} decode steps")
    emit({"phase": "tiny-slots", "requests": len(prompts),
          "tokens": sum(len(s) for s in got["streams"]),
          "streams_equal_cpu": True, "streams_equal_paged": True,
          "paged_launches": paged.launches})


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _counters():
    from repro_torch.kernels.abft_matmul.kernel import abft_matmul_ext
    from repro_torch.kernels.block_hash.kernel import hash_leaves
    from repro_torch.kernels.ckpt_codec.kernel import (dequantize_blocks,
                                                       quantize_blocks)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bshd, flash_attention_bshd_bwd)
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_rhd
    from repro_torch.kernels.rmsnorm.kernel import (rms_norm_2d,
                                                    rms_norm_2d_bwd)
    from repro_torch.kernels.selective_scan.kernel import (
        selective_scan_bwd_kernel, selective_scan_kernel)

    return {"rmsnorm": rms_norm_2d, "flash_attention": flash_attention_bshd,
            "paged_attention": paged_attention_rhd,
            "rmsnorm_bwd": rms_norm_2d_bwd,
            "flash_attention_bwd": flash_attention_bshd_bwd,
            "ckpt_quantize": quantize_blocks,
            "ckpt_dequantize": dequantize_blocks,
            "block_hash": hash_leaves, "abft_matmul": abft_matmul_ext,
            "selective_scan": selective_scan_kernel,
            "selective_scan_bwd": selective_scan_bwd_kernel}


def phase_serve(seed: int):
    from repro_torch.models import get_config, init_params
    from repro_torch.obs import Observability

    cfg = get_config("granite-3-8b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _prompts(cfg.vocab_size, seed, PROMPT_LENS)
    counters = {k: fn for k, fn in _counters().items()
                if k in ("rmsnorm", "flash_attention", "paged_attention",
                         "selective_scan")}
    L = cfg.num_layers
    runs = {}
    # the fault-free run times each replica's engine steps (an empty risk
    # source: the engine emits telemetry/replica_step and drains nothing)
    # to size the serve-predrain run's latency spikes
    timing = Observability()
    for label, kill in (("fault_free", False), ("replica_kill", True)):
        for fn in counters.values():
            fn.launches = 0
        telemetry = ({} if kill else
                     {"obs": timing, "risk_source": lambda: {}})
        res = _serve(cfg, params, prompts, GEN, "cuda", kill=kill,
                     **telemetry)
        launches = _serve_launches(label, counters, res, L)
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
    slot_launches = phase_serve_slots(cfg, params, prompts, a, counters)
    standby = phase_serve_standby(cfg, params, prompts, counters)
    phase_steps(cfg, params, seed)
    predrain = phase_serve_predrain(cfg, params, prompts, a,
                                    timing.events("telemetry",
                                                  "replica_step"),
                                    counters)
    return {"serve": runs["fault_free"][1], "serve_slots": slot_launches,
            "serve_standby": standby, "serve_predrain": predrain}


def _serve_launches(label, counters, res, L, attn=None):
    """The launch counters after a serve run, held to its path: an
    RMSNorm per norm (2 a layer + the final one) of every prefill and
    decode call, a flash launch an attention layer (``attn`` of the L, all
    by default; an RG-LRU stack's LOCAL layers) a prefill, a paged launch
    an attention layer a decode call (paged pool or slot rows), no
    scan."""
    attn = L if attn is None else attn
    launches = {k: fn.launches for k, fn in counters.items()}
    want = {"rmsnorm": (2 * L + 1) * (res["prefills"] + res["decode_calls"]),
            "flash_attention": attn * res["prefills"],
            "paged_attention": attn * res["decode_calls"],
            "selective_scan": 0}
    if launches != want or min(v for k, v in launches.items()
                               if want[k]) <= 0:
        raise AssertionError(f"{label}: launches {launches}, the path "
                             f"implies {want}")
    return launches


def _serve_summary(res):
    ttft = [t for _, t, _ in res["latencies"]]
    total = sorted(t for _, _, t in res["latencies"])
    tokens = sum(len(s) for s in res["streams"])
    return {"tokens": tokens, "wall_s": res["wall"],
            "tok_s": tokens / res["wall"],
            "ttft_p50_ms": statistics.median(ttft) * 1e3,
            "latency_p50_ms": statistics.median(total) * 1e3,
            "retried": res["retried"], "dropped": res["dropped"],
            "prefills": res["prefills"], "decode_calls": res["decode_calls"],
            "entropy_ema": res["entropy_ema"]}


def phase_serve_slots(cfg, params, prompts, paged, counters):
    """``serve-slots``: the serve phase's fault-free run from the slot pool
    (``paged=False``, the CLI's ``--legacy-pool``): 2 replicas of
    ``MAX_ACTIVE`` slots, so each decode step has the paged run's 8 rows,
    and rows of ``MAX_LEN`` positions (the paged run's prefill length).
    The streams must equal the paged run's token for token (the
    reference's determinism contract), nothing dropped, the sentinel
    quiet, no slot held after the run, launches held to the path (the
    decode's attention is the paged kernel over a page view of the
    rows)."""
    for fn in counters.values():
        fn.launches = 0
    res = _serve(cfg, params, prompts, GEN, "cuda", paged=False,
                 slots=MAX_ACTIVE)
    launches = _serve_launches("serve-slots", counters, res, cfg.num_layers)
    if res["dropped"] or None in res["streams"]:
        raise AssertionError(f"serve-slots: dropped {res['dropped']}")
    if res["failures"]:
        raise AssertionError(f"serve-slots: a replica failed (decode "
                             f"sentinel or heartbeat): {res['failures']}")
    if res["streams"] != paged["streams"]:
        diff = [i for i, (x, y) in enumerate(zip(res["streams"],
                                                 paged["streams"]))
                if x != y]
        raise AssertionError(f"serve-slots: streams differ from the paged "
                             f"run's for requests {diff}")
    emit({"phase": "serve-slots", "arch": cfg.name, "layers": cfg.num_layers,
          "replicas": 2, "slots": MAX_ACTIVE, "cache_len": MAX_LEN,
          "requests": len(prompts), "gen": GEN, **_serve_summary(res),
          "streams_equal_paged": True,
          "sentinel_ceiling": 0.98 * math.log(cfg.padded_vocab),
          "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def phase_serve_standby(cfg, params, prompts, counters):
    """``serve-standby``: the serve-slots engine with one warm standby, at
    STANDBY_LAYERS of granite's layers (the serve phase's first ones,
    shared, not copied).  A fault-free slot run gives the streams to hold
    the kill run to.  The parameters are saved once, raw, with
    ``CheckpointManager`` into a temporary directory under ``build/``
    (removed afterwards), and the standby comes from
    ``make_standby_source``.  Replica 1 is killed at ``KILL_STEP``: a
    ``standby_activated`` event after the failure, nothing dropped,
    streams token-identical to the fault-free run, the restored
    parameters bit-equal to the live ones leaf by leaf, launches held to
    the path.  The restore blocks the engine's loop for seconds, so the
    heartbeat timeout is wide (the injector kills, not the monitor)."""
    from repro_torch.core import CheckpointManager
    from repro_torch.serve import make_standby_source

    cfg = dataclasses.replace(cfg, num_layers=STANDBY_LAYERS)
    params = dict(params, layers=params["layers"][:STANDBY_LAYERS])
    slots = _serve(cfg, params, prompts, GEN, "cuda", paged=False,
                   slots=MAX_ACTIVE)
    if slots["dropped"] or slots["failures"] or None in slots["streams"]:
        raise AssertionError(f"serve-standby: the fault-free run dropped "
                             f"{slots['dropped']}, failures "
                             f"{slots['failures']}")
    tmp = tempfile.mkdtemp(prefix="standby_", dir=_ckpt_root())
    manager = CheckpointManager(tmp, fsync="none")
    restored = {}
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save = manager.save(0, {"params": params})
        save_s = time.perf_counter() - t0
        source = make_standby_source(manager, params)

        def standby():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restored["params"] = source()
            torch.cuda.synchronize()
            restored["seconds"] = time.perf_counter() - t0
            return restored["params"]

        for fn in counters.values():
            fn.launches = 0
        res = _serve(cfg, params, prompts, GEN, "cuda", paged=False,
                     slots=MAX_ACTIVE, kill=True, standby=standby,
                     heartbeat_timeout_factor=600.0)
        launches = _serve_launches("serve-standby", counters, res,
                                   cfg.num_layers)
        events = res["events"]
        if ("replica_failed" not in events or "standby_activated" not in
                events[events.index("replica_failed"):]):
            raise AssertionError(f"serve-standby: events {events}")
        if len(res["failures"]) != 1:
            raise AssertionError(f"serve-standby: failures "
                                 f"{res['failures']}, want the kill alone")
        if res["dropped"] or None in res["streams"]:
            raise AssertionError(f"serve-standby: dropped {res['dropped']}")
        if res["streams"] != slots["streams"]:
            diff = [i for i, (x, y) in enumerate(zip(res["streams"],
                                                     slots["streams"]))
                    if x != y]
            raise AssertionError(f"serve-standby: streams differ from the "
                                 f"fault-free run's for requests {diff}")
        if not _tree_equal(restored["params"], params):
            raise AssertionError("serve-standby: the standby's parameters "
                                 "differ from the live ones")
        emit({"phase": "serve-standby", "arch": cfg.name,
              "layers": cfg.num_layers, "replicas": 2, "slots": MAX_ACTIVE,
              "requests": len(prompts), "gen": GEN, "kill_step": KILL_STEP,
              **_serve_summary(res), "events": events,
              "token_identical": True, "params_bit_equal": True,
              "save_bytes": save.bytes_written,
              "save_snapshot_s": save.snapshot_seconds,
              "save_write_s": save.write_seconds, "save_s": save_s,
              "restore_s": restored["seconds"], "launches": launches,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    finally:
        restored.clear()
        manager.close()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return launches


PREDRAIN_SPIKES = range(3, 15)     # engine steps replica 1 sleeps at
PREDRAIN_KILL = 16                 # its kill, which must never fire


def phase_serve_predrain(cfg, params, prompts, fault_free, timed,
                         counters):
    """The serving plane's telemetry path: ``serve-predrain``.  The serve
    phase's engine with an ``Observability``, an ``AnomalyEngine`` whose
    step-time drift detector watches the engine's per-replica step
    timings, ``risk_source=anomaly.risk_scores`` and a pre-drain
    threshold of 0.8.  Replica 1 sleeps at engine steps 3-14 and is
    killed at step 16: the detector must turn the sleeps into a
    precursor, the engine must pre-drain replica 1 before the kill, and
    the kill never fires.  The sleep is sized from replica 1's engine
    steps in the fault-free run (``timed``, its telemetry/replica_step
    events): at least 5 of its decode steps (the median past the
    admissions), and 8 times the baseline the detector builds over its
    first 3 steps (prefills included).  A drifted step scores 0.8 once it
    exceeds 3.2 times the baseline, so the run tolerates a warm-up up to
    2.5 times slower than the fault-free run's (the host-bound first
    steps vary from run to run: 1.2 times between two runs of one
    tree)."""
    from repro_torch.chaos import (check_detect_before_act,
                                   check_token_identical, check_zero_drop,
                                   verify)
    from repro_torch.core import FaultInjector
    from repro_torch.obs import (AnomalyEngine, Observability,
                                 StepTimeDriftDetector)

    ones = [e.data["seconds"] for e in timed if e.data["replica"] == 1]
    decode_s = statistics.median(ones[3:])
    probe = StepTimeDriftDetector(factor=2.0, consecutive=3, warmup=3)
    for e in [e for e in timed if e.data["replica"] == 1][:3]:
        probe.observe(0, e)
    baseline_s = probe._mean[1]
    spike = max(5 * decode_s, 8 * baseline_s)
    injector = FaultInjector()
    for step in PREDRAIN_SPIKES:
        injector.schedule_latency_spike(step, spike, replica_id=1)
    injector.schedule_replica_kill(PREDRAIN_KILL, replica_id=1)
    obs = Observability()
    anomaly = AnomalyEngine(detectors=[StepTimeDriftDetector(
        factor=2.0, consecutive=3, warmup=3)])
    anomaly.attach(obs.bus)
    for fn in counters.values():
        fn.launches = 0
    res = _serve(cfg, params, prompts, GEN, "cuda", injector=injector,
                 obs=obs, risk_source=anomaly.risk_scores,
                 pre_drain_threshold=0.8)
    L = cfg.num_layers
    launches = _serve_launches("serve-predrain", counters, res, L)
    pre = res["predrained"]
    if [e["replica"] for e in pre] != [1]:
        steps_ms = [(e.data["replica"], round(e.data["seconds"] * 1e3, 1))
                    for e in obs.events("telemetry", "replica_step")]
        raise AssertionError(
            f"serve-predrain: pre-drains {pre}, want exactly one, of "
            f"replica 1; spike {spike:.3f} s, fault-free replica 1 steps "
            f"{[round(t * 1e3, 1) for t in ones[:8]]} ms, baseline "
            f"{baseline_s * 1e3:.1f} ms; this run's steps {steps_ms[:24]};"
            f" precursors {[e.data for e in obs.events('precursor')]}; "
            f"risk {anomaly.risk_scores()}")
    if res["failures"] or injector.replica_kills:
        raise AssertionError(f"serve-predrain: failures {res['failures']},"
                             f" kills {injector.replica_kills}: the decode "
                             "sentinel tripped or the kill fired")
    verify([check_zero_drop(res["scheduler"], res["rids"]),
            check_token_identical(dict(zip(res["rids"], res["streams"])),
                                  dict(zip(res["rids"],
                                           fault_free["streams"]))),
            check_detect_before_act(obs.events())])
    if res["dropped"]:
        raise AssertionError(f"serve-predrain: dropped {res['dropped']}")
    precursors = obs.events(subsystem="precursor")
    victim = res["hosts"][1][0]
    if not precursors or precursors[0].data["host"] != victim:
        raise AssertionError(f"serve-predrain: first precursor "
                             f"{precursors[:1]}, replica 1 is host "
                             f"{victim}")
    t_pre = obs.events("serve", "replica_predrained")[0].t_mono
    step_s = [e.data["seconds"] for e in
              obs.events("telemetry", "replica_step")]
    emit({"phase": "serve-predrain", "arch": cfg.name, "layers": L,
          "replicas": 2, "requests": len(prompts), "gen": GEN,
          "spike_steps": [PREDRAIN_SPIKES.start, PREDRAIN_SPIKES.stop - 1],
          "spike_s": spike, "decode_step_ms": decode_s * 1e3,
          "baseline_ms": baseline_s * 1e3,
          "fault_free_replica1_steps_ms": [t * 1e3 for t in ones[:6]],
          "replica1_steps_ms": [e.data["seconds"] * 1e3 for e in
                                obs.events("telemetry", "replica_step")
                                if e.data["replica"] == 1],
          "kill_step": PREDRAIN_KILL, "predrained": pre,
          "predrain_step": pre[0]["step"],
          "steps_ahead_of_kill": PREDRAIN_KILL - pre[0]["step"],
          "precursors": [(e.data["host"], e.data["score"], e.data["risk"])
                         for e in precursors],
          "precursor_to_predrain_ms": (t_pre - precursors[0].t_mono) * 1e3,
          "replica_steps": len(step_s),
          "retried": res["retried"], "dropped": res["dropped"],
          "token_identical": True, "detect_before_act": True,
          "entropy_ema": res["entropy_ema"], "wall_s": res["wall"],
          "timeline": obs.snapshot()["timeline"], "launches": launches})
    return launches


def phase_steps(cfg, params, seed: int, calls: int = 10,
                rows: int = MAX_ACTIVE, phase: str = "steps"):
    """Where a serve step's time goes: one decode step (``rows`` rows) and
    one prefill of a 200-token prompt, padded for an attention stack
    (``launch/profile_steps.serve_steps``), each run eagerly and ended by
    a synchronize as the engine runs it (host clock), and captured in a
    CUDA graph (device time alone).  The difference is the host's share:
    Python, dispatch and the launches the card waits for.  Then the
    decode step's device ms in the paged-attention and RMSNorm kernels
    (``profile_step``'s groups) beside the parent tree's reading."""
    from repro_torch.launch.profile_steps import profile_step, serve_steps
    from repro_torch.serve.engine import _supports_paging

    steps = serve_steps(cfg, params, device="cuda", seed=seed,
                        max_active=rows, page_size=PAGE_SIZE,
                        max_len=MAX_LEN, prompt_len=200)
    out = {"phase": phase, "arch": cfg.name, "decode_rows": rows,
           "prefill_tokens": 200,
           "prefill_padded_to": MAX_LEN if _supports_paging(cfg) else 200}
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
        # the decode step's device ms in the two redesigned kernels,
        # profiled without programmatic dependent launch (as _paged_cases)
        groups = _no_pdl(profile_step, steps["decode"])["device_ms_by_group"]
        if phase == "steps-ssm":
            # the prefill's scan group: a launch a layer
            pre = _no_pdl(profile_step, steps["prefill"])
            scans = pre["launches_by_group"].get("selective_scan", 0)
            if scans != cfg.num_layers:
                raise AssertionError(f"steps-ssm: {scans} scan launches in "
                                     f"a prefill of {cfg.num_layers} layers")
            out.update({
                "prefill_profiled_device_ms": pre["device_ms"],
                "prefill_scan_launches": scans,
                "prefill_scan_device_ms":
                    pre["device_ms_by_group"]["selective_scan"],
                "prefill_scan_device_ms_before": PREFILL_SCAN_BEFORE})
    out["decode_kernels_device_ms"] = {k: groups.get(k, 0.0)
                                       for k in STEP_GROUPS}
    out["decode_kernels_device_ms_before"] = STEP_GROUPS_BEFORE.get(phase)
    out["before_at_layers"] = STEPS_BEFORE_LAYERS.get(phase)
    emit(out)


SSM_SLOTS = 4


def _ssm_consistency(cfg, params, prompt, stream, tol=FP32_TOL):
    """prefill(prompt) then one decode step a generated token against the
    row must give the logits (at every position) and the conv and scan
    state of prefill(prompt + generated): the kernel's h_last and the
    decode step held to each other.  Returns the largest error as a
    fraction of the largest magnitude."""
    from repro_torch.models import forward, init_cache

    def prefill(tokens):
        row = init_cache(cfg, 1, 0, "cuda")
        logits, row = forward(cfg, params, {"tokens": torch.tensor(
            [tokens], device="cuda")}, mode="prefill", cache=row)
        return logits[0], row

    with torch.no_grad():
        got, row = prefill(prompt)
        got = [got]
        for tok in stream[:-1]:
            logits, row = forward(cfg, params, {"tokens": torch.tensor(
                [[tok]], device="cuda")}, mode="decode", cache=row)
            got.append(logits[0])
        want, want_row = prefill(list(prompt) + list(stream[:-1]))
    worst = 0.0
    pairs = [("logits", torch.cat(got), want)] + [
        (f"layer {i} {n}", row["layers"][i][n], want_row["layers"][i][n])
        for i in range(cfg.num_layers) for n in ("conv", "h")]
    for name, a, b in pairs:
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        if not err <= tol * max(scale, 1e-30):
            raise AssertionError(f"tiny-ssm consistency: {name} error "
                                 f"{err:.3g} beyond {tol} of {scale:.3g}")
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def phase_tiny_ssm(seed: int):
    """The Mamba serving path on the card against the plain versions on
    the CPU: tiny falcon-mamba in float32 through the slot pool, one set
    of weights on both; then prefill + decode against one long prefill."""
    from repro_torch.models import get_config, init_params

    scan = _counters()["selective_scan"]
    cfg = dataclasses.replace(get_config("falcon-mamba-7b", tiny=True),
                              dtype=torch.float32)
    cpu = init_params(cfg, seed=seed, device="cpu")
    gpu = _tree_to(cpu, "cuda")
    # the three lengths, and prompts of 1 and 2 tokens (the one-token
    # prompt takes the single-step branch; 2 < W - 1 keeps zero padding
    # in the conv state)
    prompts = _prompts(cfg.vocab_size, seed, (16, 24, 32)) + [[7], [3, 9]]
    kw = dict(replicas=1, max_len=48, slots=SSM_SLOTS)
    want = _serve(cfg, cpu, prompts, 8, "cpu", **kw)
    scan.launches = 0
    got = _serve(cfg, gpu, prompts, 8, "cuda", **kw)
    if got["streams"] != want["streams"] or None in got["streams"]:
        raise AssertionError(f"tiny float32 Mamba streams differ between "
                             f"the card and the CPU:\n{got['streams']}\n"
                             f"{want['streams']}")
    multi = sum(len(p) > 1 for p in prompts)
    served = scan.launches
    if served != cfg.num_layers * multi:
        raise AssertionError(f"tiny-ssm: {served} scan launches for "
                             f"{multi} multi-token prefills")
    err = max(_ssm_consistency(cfg, gpu, prompts[i], got["streams"][i])
              for i in (1, 2))
    emit({"phase": "tiny-ssm", "requests": len(prompts),
          "tokens": sum(len(s) for s in got["streams"]),
          "streams_equal_cpu": True, "scan_launches": served,
          "prefill_decode_vs_prefill_max_rel_err": err, "tol": FP32_TOL})


def phase_serve_ssm(seed: int):
    from repro_torch.models import get_config, init_params
    from repro_torch.serve import pctl

    cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                              num_layers=SSM_SERVE_LAYERS)
    resident = torch.cuda.memory_allocated() / 1e9
    if resident > 2.0:
        raise AssertionError(f"serve-ssm: {resident:.2f} GB still allocated "
                             "before the Mamba weights (granite's not freed)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _prompts(cfg.vocab_size, seed, PROMPT_LENS)
    if min(len(p) for p in prompts) < 2:
        raise AssertionError("every serve-ssm prompt should be scanned")
    counters = {k: fn for k, fn in _counters().items()
                if k in ("rmsnorm", "flash_attention", "paged_attention",
                         "selective_scan")}
    L = cfg.num_layers
    ceiling = 0.98 * math.log(cfg.padded_vocab)
    runs = {}
    scan = counters["selective_scan"]
    for label, kill in (("fault_free", False), ("replica_kill", True)):
        for fn in counters.values():
            fn.launches = 0
        scan.tma_launches = 0
        res = _serve(cfg, params, prompts, GEN, "cuda", kill=kill,
                     slots=SSM_SLOTS)
        launches = {k: fn.launches for k, fn in counters.items()}
        want = {"rmsnorm": (L + 1) * (res["prefills"] + res["decode_calls"]),
                "flash_attention": 0, "paged_attention": 0,
                "selective_scan": L * res["prefills"]}
        if launches != want or min(launches["rmsnorm"],
                                   launches["selective_scan"]) <= 0:
            raise AssertionError(f"serve-ssm {label}: launches {launches}, "
                                 f"the path implies {want}")
        # B and C of a bf16 model reach the scan as slices of one
        # contiguous float32 (B, S, 2N) tensor: every launch takes TMA
        if scan.tma_launches != launches["selective_scan"]:
            raise AssertionError(f"serve-ssm {label}: {scan.tma_launches} "
                                 f"of {launches['selective_scan']} scans "
                                 "took the TMA route")
        if res["dropped"] or None in res["streams"]:
            raise AssertionError(f"serve-ssm {label}: dropped "
                                 f"{res['dropped']}")
        if kill and not res["failures"]:
            raise AssertionError("the scheduled replica kill never fired")
        if not kill and res["failures"]:
            raise AssertionError(f"serve-ssm: the fault-free run failed a "
                                 f"replica (decode sentinel or heartbeat): "
                                 f"{res['failures']}")
        ttft = [t for _, t, _ in res["latencies"]]
        total = sorted(t for _, _, t in res["latencies"])
        tokens = sum(len(s) for s in res["streams"])
        emit({"phase": "serve-ssm", "run": label, "arch": cfg.name,
              "layers": L, "d_model": cfg.d_model, "d_inner": cfg.d_inner,
              "ssm_state": cfg.ssm_state,
              "padded_vocab": cfg.padded_vocab, "dtype": str(cfg.dtype),
              "replicas": 2, "slots": SSM_SLOTS, "requests": len(prompts),
              "gen": GEN, "prompt_lens": [len(p) for p in prompts],
              "tokens": tokens, "wall_s": res["wall"],
              "tok_s": tokens / res["wall"],
              "ttft_p50_ms": statistics.median(ttft) * 1e3,
              "latency_p50_ms": statistics.median(total) * 1e3,
              "latency_p99_ms": pctl(total, 0.99) * 1e3,
              "replica_failures": len(res["failures"]),
              "failure_reasons": [f["reason"] for f in res["failures"]],
              "retried": res["retried"], "dropped": res["dropped"],
              "prefills": res["prefills"],
              "decode_calls": res["decode_calls"], "launches": launches,
              "scan_tma_launches": scan.tma_launches,
              "entropy_ema": res["entropy_ema"],
              "sentinel_ceiling": ceiling,
              "resident_gb_before_weights": resident,
              "weights_init_s": init_s,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        runs[label] = (res, launches)
    a, b = runs["fault_free"][0], runs["replica_kill"][0]
    if a["streams"] != b["streams"]:
        diff = [i for i, (x, y) in enumerate(zip(a["streams"], b["streams"]))
                if x != y]
        raise AssertionError(f"serve-ssm: streams after the replica kill "
                             f"differ from the uninterrupted run for "
                             f"requests {diff}")
    emit({"phase": "serve-ssm", "token_identical_after_kill": True})
    phase_steps(cfg, params, seed, rows=SSM_SLOTS, phase="steps-ssm")
    del params
    torch.cuda.empty_cache()
    return runs["fault_free"][1]


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


def _protected_run(state, data, step_fn, ckpt_dir, *, steps, fail_at=None,
                   bitflip=None, straggles=(), obs=None, proactive=None,
                   **config):
    """``run_with_recovery`` through the facade with a fail-stop at
    ``fail_at`` or a scheduled ``bitflip`` (step, leaf, bit), and
    ``straggles`` ((step, extra seconds), ...); ``obs`` is attached to the
    facade and the injector, and ``proactive(dep)`` builds the loop's
    proactive hook.  Saves every ``TRAIN_EVERY`` steps unless ``config``
    names another policy.  Returns (state, info, facade, train-step
    calls, the metrics of every step of every attempt, in order)."""
    from repro_torch.core import (Dependability, DependabilityConfig,
                                  FaultInjector, run_with_recovery)

    config = {"policy_mode": "every_n", "every_n": TRAIN_EVERY, **config}
    dep = Dependability(DependabilityConfig(
        checkpoint_dir=ckpt_dir, signal_detection=False, **config))
    if obs is not None:
        dep.attach_obs(obs)
    dep.start()
    dep.register_local_state(data)
    dep.register_global_state(state)
    injector = FaultInjector(obs=obs)
    if fail_at is not None:
        injector.schedule_failstop(fail_at)
    if bitflip is not None:
        injector.schedule_bitflip(*bitflip)
    for step, extra in straggles:
        injector.schedule_straggle(step, extra)
    calls = [0]
    metrics = []

    def counted(st, batch):
        calls[0] += 1
        return step_fn(st, batch)

    try:
        out, info = run_with_recovery(
            dep, counted, state, data, steps, fault_injector=injector,
            on_metrics=lambda step, rec: metrics.append(rec),
            proactive=proactive(dep) if proactive is not None else None)
        torch.cuda.synchronize()
    finally:
        dep.stop()
    faults = (fail_at is not None) + (bitflip is not None)
    if info["status"] != "done" or info["restarts"] != faults:
        raise AssertionError(f"protected run: {info['status']}, "
                             f"{info['restarts']} restarts")
    # the history keeps the last attempt's steps only: every step's
    # metrics come through on_metrics, one record a train-step call
    losses = [m["loss"] for m in metrics]
    if len(losses) != calls[0] or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"protected run: {calls[0]} train-step calls, "
                             f"losses {losses}")
    return out, info, dep, calls[0], metrics


def phase_train_tiny(seed: int, arch: str = "granite-3-8b",
                     phase: str = "train-tiny"):
    """Tiny ``arch`` in float32 on the card: a run with a fail-stop and raw
    saves ends bit-equal to an uninterrupted card run; the card's losses
    match the CPU's (plain versions) to float32 tolerance (1e-4 relative:
    the two sum in different orders)."""
    from repro_torch.data import make_pipeline
    from repro_torch.models import get_config
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.step import metrics_to_host

    steps = 9
    cfg = dataclasses.replace(get_config(arch, tiny=True),
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
            raise AssertionError(f"{phase}: card losses {losses['cuda']}"
                                 f" vs CPU {losses['cpu']}")
    tmp = tempfile.mkdtemp(dir=_ckpt_root())
    try:
        out, info, _, _, _ = _protected_run(
            _tree_to(cpu_state, "cuda"), make_pipeline(cfg, 32, 4, seed=seed),
            step_fn, tmp, steps=steps, fail_at=TRAIN_FAIL, async_save=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not _tree_equal(out, uninterrupted):
        raise AssertionError(f"{phase}: the recovered run's state differs "
                             "from the uninterrupted run's")
    emit({"phase": phase, "arch": cfg.name, "dtype": "float32",
          "steps": steps, "fail_stop_at": TRAIN_FAIL,
          "restarts": info["restarts"], "recovered_bit_equal": True,
          "card_losses": losses["cuda"], "cpu_losses": losses["cpu"]})


def _train_launches(L: int, microbatches: int, calls: int,
                    ssm: bool = False, rec: int = 0):
    """Launches the train path implies: per microbatch each of L layers
    runs its 2 RMSNorms and 1 attention forward (an SSM layer: 1 RMSNorm
    and 1 scan; an RG-LRU layer, ``rec`` of the L: 2 RMSNorms and no
    attention) twice (the forward and the recomputation of the
    backward), the final norm once; each backward once."""
    mb = calls * microbatches
    norms = 1 if ssm else 2
    attn = 0 if ssm else L - rec
    return {"rmsnorm": mb * (2 * norms * L + 1),
            "rmsnorm_bwd": mb * (norms * L + 1),
            "flash_attention": mb * 2 * attn,
            "flash_attention_bwd": mb * attn,
            "selective_scan": mb * 2 * L if ssm else 0,
            "selective_scan_bwd": mb * L if ssm else 0}


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
              "flash_fwd_ms": prof["device_ms_by_group"].get(
                  "flash_attention", 0.0),
              "flash_bwd_ms": prof["device_ms_by_group"].get(
                  "flash_attention_bwd", 0.0),
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
                "paged_attention": 0, "block_hash": 0, "abft_matmul": 0,
                "ckpt_quantize": eligible * saves,
                "ckpt_dequantize": eligible * restores}
        if launches != want or min(launches[k] for k in want
                                   if want[k]) <= 0:
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


SDC_STEPS = 8
SDC_FLIP_STEP = 7          # after the save at step 6: a rollback to it
SDC_LEAF = "params.blocks.l0.mlp.w_in"


def _sdc_config(**extra):
    return dict(delta_checkpoint=True, full_every=3, keep=10, scrub=True,
                scrub_fraction=1.0, **extra)


def phase_train_tiny_sdc(seed: int):
    """Tiny granite in float32 on the card with raw delta saves, the
    scrubber over every leaf and a bit-flip in ``SDC_LEAF``: the scrubber
    names exactly that leaf, one rollback, the final state bit-equal to an
    uninterrupted card run, and the losses of every train-step call equal
    to the same protected run's on the CPU (plain versions) to the
    train-tiny phase's tolerance."""
    from repro_torch.data import make_pipeline
    from repro_torch.models import get_config
    from repro_torch.train import init_state, make_train_step

    cfg = dataclasses.replace(get_config("granite-3-8b", tiny=True),
                              dtype=torch.float32)
    cpu_state = init_state(cfg, seed=seed, device="cpu")
    step_fn = make_train_step(cfg, total_steps=SDC_STEPS, warmup_steps=1)
    flip = (SDC_FLIP_STEP, SDC_LEAF, 30)
    runs = {}
    for device, bitflip in (("cpu", flip), ("cuda", flip), ("cuda", None)):
        tmp = tempfile.mkdtemp(dir=_ckpt_root())
        try:
            runs[device, bitflip is not None] = _protected_run(
                _tree_to(cpu_state, device),
                make_pipeline(cfg, 32, 4, seed=seed), step_fn, tmp,
                steps=SDC_STEPS, bitflip=bitflip,
                **_sdc_config(delta_block=256))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    out, info, dep, calls, metrics = runs["cuda", True]
    events = [h["event"] for h in info["history"] if "event" in h]
    if events != [f"corruption:scrub:{SDC_LEAF}"] or info["restarts"] != 1:
        raise AssertionError(f"tiny SDC: events {events}, "
                             f"{info['restarts']} restarts")
    clean = runs["cuda", False]
    if clean[1]["restarts"] or not _tree_equal(out, clean[0]):
        raise AssertionError("tiny SDC: the recovered state differs from "
                             "the uninterrupted card run's")
    card = [m["loss"] for m in metrics]
    cpu = [m["loss"] for m in runs["cpu", True][4]]
    if len(card) != len(cpu) or not all(
            abs(a - b) <= 1e-4 * max(1.0, abs(b)) for a, b in zip(card, cpu)):
        raise AssertionError(f"tiny SDC: card losses {card} vs CPU {cpu}")
    emit({"phase": "train-tiny-sdc", "arch": cfg.name, "dtype": "float32",
          "steps": SDC_STEPS, "bitflip": list(flip), "events": events,
          "restarts": info["restarts"], "recovered_bit_equal": True,
          "saves": [(st.step, st.kind, st.dirty_blocks, st.total_blocks)
                    for st in dep.save_history],
          "card_losses": card, "cpu_losses": cpu,
          "max_loss_diff": max(abs(a - b) for a, b in zip(card, cpu))})


def _manifest_counts(ckpt_dir, step):
    """(device-encoded shards, leaves a restore decodes on the card) of
    ``step``'s manifest: a delta shard of a floating leaf is assembled from
    its coded chain and decoded once, as a coded full shard is."""
    with open(Path(ckpt_dir) / f"step_{step:08d}" / "manifest_h0.json") as f:
        entries = list(json.load(f)["arrays"].values())
    shards = [(e["dtype"], sh) for e in entries for sh in e["shards"]]
    return (sum(1 for _, sh in shards if "codec" in sh),
            sum(1 for dt, sh in shards if "codec" in sh or (
                "delta" in sh and dt in ("float32", "bfloat16"))))


def _sdc_launches(ckpt_dir, info, dep, calls, detections, n_leaves, L):
    """Launches a protected run with delta saves, the int8 device codec
    and the scrubber over every leaf implies: one grouped block_hash a
    scrub record (each completed step), a save, and a verification of a
    recorded window (at the top of every superstep but the first of each
    attempt, and where it tripped); a quantize a device-encoded shard
    saved, a dequantize a leaf the restore decodes.  Returns (launches,
    restored step, scrub records, scrub verifications)."""
    saves = dep.save_history
    restored = [int(h["step"]) for h in info["history"]
                if "loss" in h][0] - 1
    quant = sum(_manifest_counts(ckpt_dir, st.step)[0] for st in saves)
    decoded = _manifest_counts(ckpt_dir, restored)[1]
    records = dep.scrubber.leaves_scrubbed // n_leaves
    verifies = calls - (info["restarts"] + 1) + detections
    want = {**_train_launches(L, TRAIN_MICRO, calls),
            "paged_attention": 0, "abft_matmul": 0,
            "ckpt_quantize": quant, "ckpt_dequantize": decoded,
            "block_hash": records + verifies + len(saves)}
    return want, restored, records, verifies


def phase_train_sdc(seed: int):
    """granite-3-8b at full width (TRAIN_LAYERS layers) through the facade
    with delta saves and the device codec, the scrubber over every leaf,
    and a bit-flip in an exponent bit of ``SDC_LEAF`` at step
    ``SDC_FLIP_STEP``: the main path of the block_hash kernel.  Then a
    frozen-state check: k blocks of one leaf change on the card, a delta
    save writes exactly those, and a restore through the chain is
    bit-equal to a full save of the same state with the same codec."""
    from repro_torch.core import CheckpointManager
    from repro_torch.data import make_pipeline
    from repro_torch.models import get_config
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import flatten_named, leaves

    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              num_layers=TRAIN_LAYERS)
    L = cfg.num_layers
    tmp = tempfile.mkdtemp(dir=_ckpt_root())
    try:
        state = init_state(cfg, seed=seed, device="cuda")
        n_leaves = len(leaves(state))
        step_fn = make_train_step(cfg, microbatches=TRAIN_MICRO,
                                  total_steps=SDC_STEPS)
        data = make_pipeline(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
        # an exponent bit of the first element of w_in (float32: bit 30)
        flip = (SDC_FLIP_STEP, SDC_LEAF, 30)
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, info, dep, calls, metrics = _protected_run(
            state, data, step_fn, tmp, steps=SDC_STEPS, bitflip=flip,
            **_sdc_config(device_codec=True, async_save=True))
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        events = [h["event"] for h in info["history"] if "event" in h]
        if events != [f"corruption:scrub:{SDC_LEAF}"] or \
                info["restarts"] != 1 or int(out["step"]) != SDC_STEPS:
            raise AssertionError(f"SDC run: events {events}, "
                                 f"{info['restarts']} restarts, ended at "
                                 f"step {int(out['step'])}")
        saves = dep.save_history
        want, restored, records, verifies = _sdc_launches(
            tmp, info, dep, calls, len(events), n_leaves, L)
        if launches != want or min(launches[k] for k in want
                                   if want[k]) <= 0:
            raise AssertionError(f"SDC run: launches {launches}, the path "
                                 f"implies {want}")
        emit({"phase": "train-sdc", "check": "protected run",
              "arch": cfg.name, "layers": L, "bitflip": list(flip),
              "status": info["status"], "restarts": info["restarts"],
              "events": events, "restored_step": restored,
              "train_step_calls": calls,
              "steps_losses": [(m["step"], m["loss"]) for m in metrics],
              "wall_s": wall, "scrub_fraction": 1.0,
              "scrub_records": records, "scrub_verifies": verifies,
              "saves": [{"step": st.step, "kind": st.kind,
                         "dirty_blocks": st.dirty_blocks,
                         "total_blocks": st.total_blocks,
                         "hash_ms": st.hash_seconds * 1e3,
                         "bytes": st.bytes_written,
                         "snapshot_s": st.snapshot_seconds,
                         "write_s": st.write_seconds} for st in saves],
              "restore_s": dep.restore_seconds, "launches": launches,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        # the scrub's cost a step: record + verify of every leaf
        from repro_torch.sdc import checksums
        flat = leaves(out)
        t0 = time.perf_counter()
        for _ in range(3):
            checksums(flat)
        checksum_ms = (time.perf_counter() - t0) / 3 * 1e3
        del state, flat
        torch.cuda.empty_cache()

        # frozen state: k dirty blocks of one leaf, one delta save
        name = "params.embed.tok"
        named = dict(flatten_named(out))
        tok = named[name].clone()
        nb = -(-tok.numel() // 65536)
        blocks = sorted({0, nb // 2, nb - 1})
        k = len(blocks)
        for b in blocks:
            tok.view(-1)[b * 65536 + 17] += 1.0
        frozen = {**out, "params": {**out["params"],
                                    "embed": {"tok": tok}}}
        ddir, fdir = Path(tmp) / "delta", Path(tmp) / "full"
        mgr = CheckpointManager(str(ddir), delta=True, device_codec=True,
                                full_every=100)
        first = mgr.save(1, out)
        second = mgr.save(2, frozen)
        if (first.kind, second.kind) != ("full", "delta") or \
                second.dirty_blocks != k:
            raise AssertionError(f"frozen state: saves {first} then "
                                 f"{second}, {k} blocks changed")
        del out
        deq = counters["ckpt_dequantize"]
        deq.launches = 0
        t0 = time.perf_counter()
        got, _ = mgr.restore(step=2, like=frozen)
        chain_s = time.perf_counter() - t0
        chain_decodes = deq.launches
        mgr.close()
        if chain_decodes != _manifest_counts(ddir, 2)[1]:
            raise AssertionError(
                f"frozen state: {chain_decodes} dequantize launches in the "
                f"chain restore, {_manifest_counts(ddir, 2)[1]} coded leaves")
        full = CheckpointManager(str(fdir), device_codec=True)
        full_save = full.save(2, frozen)
        want_state, _ = full.restore(step=2, like=frozen)
        full.close()
        if not _tree_equal(got, want_state):
            raise AssertionError("frozen state: the restore through the "
                                 "delta chain differs from a full save's")
        emit({"phase": "train-sdc", "check": "frozen state",
              "leaf": name, "changed_blocks": blocks,
              "dirty_blocks": second.dirty_blocks,
              "total_blocks": second.total_blocks,
              "delta_bytes": second.bytes_written,
              "delta_snapshot_s": second.snapshot_seconds,
              "delta_hash_ms": second.hash_seconds * 1e3,
              "full_bytes": full_save.bytes_written,
              "full_snapshot_s": full_save.snapshot_seconds,
              "chain_restore_s": chain_s,
              "chain_dequantize_launches": chain_decodes,
              "restore_bit_equal": True,
              "checksum_all_leaves_ms": checksum_ms})
        del got, want_state, frozen, tok, named
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return launches


OBS_STEPS = 12
OBS_STRAGGLES = (5, 6, 7)  # straggled steps: the drift detector's input
OBS_FLIP_STEP = 10         # after the proactive save the straggles force
# a straggled step sleeps this many warm steps: the drift detector's
# baseline (steps 1-3) runs beside the async write of step 1's full save
# (1.07 and 1.36 warm steps in two runs on an H100), and a straggled
# step must pass twice it
OBS_STRAGGLE = 5
OBS_BUDGET = 0.02          # instrumentation's host share of a step


def _prom_ok(text: str) -> bool:
    """Every sample line of a Prometheus text exposition is ``name value``
    with a float value."""
    lines = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
    return bool(lines) and all(
        math.isfinite(float(ln.rsplit(" ", 1)[1])) for ln in lines)


def phase_train_obs(seed: int):
    """The training plane's telemetry path: ``train-obs``.  granite-3-8b
    at full width (TRAIN_LAYERS layers) through the facade with an
    ``Observability`` (a JSONL sink under the phase's directory), the
    train-sdc phase's delta saves, int8 device codec and scrubber, the
    ``risk_adjusted`` policy, an ``AnomalyEngine`` on the bus and
    ``make_proactive_hook(..., policy=dep.policy)`` as the loop's
    proactive hook.  Steps ``OBS_STRAGGLES`` straggle (``OBS_STRAGGLE``
    times the warm step's eager ms each), a bit-flip strikes an exponent bit of
    ``SDC_LEAF`` at step ``OBS_FLIP_STEP``: the drift detector names host
    0, the hook forces a save before the flip, the policy's interval
    contracts, the scrubber names the leaf, one incident opens at the
    corruption and closes at the resume, detect-before-act holds, the
    JSONL log equals the ring, the bundle parses and the log converts to
    a valid scenario; the instrumentation's host time (the facade's and
    the loop's emits and metric updates, the detectors inside them, the
    hook) stays under ``OBS_BUDGET`` of a step's eager ms."""
    import copy

    from repro_torch.chaos import check_detect_before_act
    from repro_torch.data import make_pipeline
    from repro_torch.models import get_config
    from repro_torch.obs import (AnomalyEngine, Observability, load_jsonl,
                                 make_proactive_hook)
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.step import metrics_to_host
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              num_layers=TRAIN_LAYERS)
    L = cfg.num_layers
    tmp = tempfile.mkdtemp(dir=_ckpt_root())
    ckpt = os.path.join(tmp, "ckpt")
    tele = os.path.join(tmp, "telemetry")
    try:
        state = init_state(cfg, seed=seed, device="cuda")
        n_leaves = len(leaves(state))
        step_fn = make_train_step(cfg, microbatches=TRAIN_MICRO,
                                  total_steps=OBS_STEPS)
        data = make_pipeline(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
        # warm the step: the drift detector's baseline is a real step,
        # and the straggles and the budget are sized from its eager ms
        batch = data.peek_batch(0)
        metrics_to_host(step_fn(state, batch)[1])
        t0 = time.perf_counter()
        metrics_to_host(step_fn(state, batch)[1])
        eager_s = time.perf_counter() - t0
        torch.cuda.empty_cache()

        obs = Observability(jsonl_path=os.path.join(tele, "events.jsonl"))
        anomaly = AnomalyEngine()
        anomaly.attach(obs.bus)
        forced = []

        def proactive(dep):
            hook = make_proactive_hook(anomaly.risk_scores,
                                       policy=dep.policy)

            def polled(step):
                why = hook(step)
                if why is not None:
                    yd = copy.copy(dep.policy)
                    yd.mode = "young_daly"
                    forced.append({"step": step, "reason": why,
                                   "risk": dep.policy.risk,
                                   "interval": dep.policy.interval_steps(),
                                   "young_daly_interval":
                                       yd.interval_steps()})
                return why
            return polled

        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        flip = (OBS_FLIP_STEP, SDC_LEAF, 30)
        t0 = time.perf_counter()
        out, info, dep, calls, metrics = _protected_run(
            state, data, step_fn, ckpt, steps=OBS_STEPS, bitflip=flip,
            straggles=[(s, OBS_STRAGGLE * eager_s) for s in OBS_STRAGGLES],
            obs=obs,
            proactive=proactive, policy_mode="risk_adjusted",
            **_sdc_config(device_codec=True, async_save=True))
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        events = [h["event"] for h in info["history"] if "event" in h]
        if events != [f"corruption:scrub:{SDC_LEAF}"] or \
                info["restarts"] != 1 or int(out["step"]) != OBS_STEPS:
            raise AssertionError(f"train-obs: events {events}, "
                                 f"{info['restarts']} restarts, ended at "
                                 f"step {int(out['step'])}")
        want, restored, _, _ = _sdc_launches(ckpt, info, dep, calls,
                                             len(events), n_leaves, L)
        if launches != want or min(launches[k] for k in want
                                   if want[k]) <= 0:
            raise AssertionError(f"train-obs: launches {launches}, the "
                                 f"path implies {want}")

        # detect -> act: precursors for host 0, a forced save before the
        # flip's detection, the risk feeding the policy
        precursors = obs.events(subsystem="precursor")
        pro = obs.events("checkpoint", "proactive")
        sdc = obs.events("sdc", "corruption")
        if not precursors or any(e.data["host"] != 0 for e in precursors):
            raise AssertionError(f"train-obs: precursors {precursors}")
        if (len(pro) != 1 or len(forced) != 1 or len(sdc) != 1
                or not pro[0].data["step"] < OBS_FLIP_STEP
                or not pro[0].t_mono < sdc[0].t_mono):
            raise AssertionError(f"train-obs: proactive saves {pro}, "
                                 f"corruption {sdc}")
        f = forced[0]
        if not (f["risk"] > 0 and f["interval"] < f["young_daly_interval"]):
            raise AssertionError(f"train-obs: the policy at the forced "
                                 f"save: {f}")
        if restored != f["step"]:
            raise AssertionError(f"train-obs: restored step {restored}, "
                                 f"the forced save was at {f['step']}")
        verdict = check_detect_before_act(obs.events())
        if not verdict:
            raise AssertionError(f"train-obs: {verdict.detail}")

        # the incident: sdc/corruption -> checkpoint/restore -> resume
        tl = obs.timeline()
        inc = tl.incidents
        if (len(inc) != 1 or not inc[0].closed
                or inc[0].cause != "sdc.corruption"
                or inc[0].resume_kind != "train.resume"
                or "checkpoint.restore" not in
                [k for _, k in inc[0].phase_offsets_ms()]):
            raise AssertionError(f"train-obs: incidents "
                                 f"{[i.to_dict() for i in inc]}")
        restore = obs.events("checkpoint", "restore")[0].data["restore_s"]

        # record and replay: the sink equals the ring, the bundle parses,
        # the log converts to a valid scenario
        obs.bus.flush()
        ring = obs.events()
        if load_jsonl(os.path.join(tele, "events.jsonl")) != ring:
            raise AssertionError("train-obs: the JSONL log differs from "
                                 "the ring")
        paths = obs.dump(os.path.join(tmp, "bundle"))
        if len(load_jsonl(paths["events"])) != len(ring):
            raise AssertionError(f"train-obs: bundle events {paths}")
        for key in ("trace", "metrics_json"):
            with open(paths[key]) as fh:
                json.load(fh)
        with open(paths["metrics_prom"]) as fh:
            if not _prom_ok(fh.read()):
                raise AssertionError("train-obs: metrics.prom")
        scenario = obs.to_scenario().validate()

        host_per_step = obs.host_seconds / calls
        share = host_per_step / eager_s
        if not share < OBS_BUDGET:
            raise AssertionError(f"train-obs: instrumentation "
                                 f"{host_per_step * 1e3:.3f} ms a step, "
                                 f"{share:.2%} of the {eager_s * 1e3:.1f} "
                                 f"ms step")
        summary = tl.summary()
        emit({"phase": "train-obs", "arch": cfg.name, "layers": L,
              "steps": OBS_STEPS, "straggles": list(OBS_STRAGGLES),
              "straggle_s": OBS_STRAGGLE * eager_s, "bitflip": list(flip),
              "status": info["status"], "restarts": info["restarts"],
              "events": events, "train_step_calls": calls,
              "losses_finite": True,
              "steps_losses": [(m["step"], m["loss"]) for m in metrics],
              "precursors": [(e.data["host"], e.data["score"],
                              e.data["risk"]) for e in precursors],
              "proactive_save": f,
              "saves": [(st.step, st.kind) for st in dep.save_history],
              "restored_step": restored,
              "incident": inc[0].to_dict(),
              "mttr_s": summary["mttr_s"],
              "availability": summary["availability"],
              "span_s": summary["span_s"], "restore_s": restore,
              "observed_R_s": dep.policy.system.restart_seconds,
              "detect_before_act": verdict.detail,
              "events_logged": len(ring),
              "events_per_step": len(ring) / calls,
              "jsonl_equals_ring": True,
              "bundle": sorted(os.path.basename(v) for v in paths.values()),
              "scenario": scenario.to_dict(),
              "step_eager_ms": eager_s * 1e3, "wall_s": wall,
              "instrumentation_ms_per_step": host_per_step * 1e3,
              "instrumentation_share": share, "launches": launches})
        obs.close()
        del state, out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return launches


ABFT_LAYERS = 2
ABFT_STEPS = 3


def _abft_grad_check(cfg, params, batch):
    """Each leaf's gradient of one batch's loss with the ABFT projections
    (bf16 model) against the plain bf16 model's: relative L2 distance at
    most twice the plain gradient's own distance from the float32 model's.
    A wrong dx or dw contraction lands near 1."""
    import numpy as np

    from repro_torch.device import deterministic_algorithms
    from repro_torch.train.step import loss_fn
    from repro_torch.tree import flatten_named, leaves, unflatten

    dev = leaves(params)[0].device
    batch = {k: torch.from_numpy(np.array(v)).to(dev)
             for k, v in batch.items()}
    grads = {}
    for key, c, impl in (("plain", cfg, None), ("abft", cfg, "abft"),
                         ("float32", dataclasses.replace(
                             cfg, dtype=torch.float32), None)):
        with deterministic_algorithms(dev):
            live = [p.detach().requires_grad_(True)
                    for p in leaves(params)]
            loss, _ = loss_fn(c, unflatten(params, live), batch, impl)
            grads[key] = [t.detach() for t in torch.autograd.grad(loss,
                                                                   live)]
        del live, loss
    names = [n for n, _ in flatten_named(params)]
    out = {}
    for i, name in enumerate(names):
        ab, pl, f32 = (grads[k][i].double()
                       for k in ("abft", "plain", "float32"))
        got = ((ab - pl).norm() / pl.norm()).item()
        noise = ((pl - f32).norm() / f32.norm()).item()
        out[name] = {"abft_vs_plain": got, "plain_vs_float32": noise}
        if not (math.isfinite(got) and got <= 2 * noise):
            raise AssertionError(f"ABFT gradient of {name}: {got:.3g} off "
                                 f"the plain one, the bf16 noise is "
                                 f"{noise:.3g}")
    del grads
    torch.cuda.empty_cache()
    return out


def phase_train_abft(seed: int):
    """granite-3-8b at full width, ABFT_LAYERS layers, S = TRAIN_SEQ, one
    sequence: ABFT_STEPS steps with ``impl="abft"`` from the state the
    plain steps start from (the main path of the abft_matmul kernel, all
    of its launches on the tensor-core route).
    First the backward: every leaf's gradient of the first batch through
    the ABFT projections against the plain bf16 step's, within twice the
    plain step's own distance from a float32 model's gradient (the bf16
    noise, measured here).  Then each loss within bf16 tolerance of the
    plain step's, no detection on clean steps, two identical ABFT steps
    bit-equal, launches held to the path (per layer and step 7
    projections: forward, recomputation and two backward contractions).
    Last, one step of each profiled: eager and device ms, and the device
    ms by kernel group."""
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.abft_matmul.kernel import abft_matmul_ext
    from repro_torch.kernels.abft_matmul.ops import (detections,
                                                     reset_detections)
    from repro_torch.launch.profile_steps import profile_step
    from repro_torch.models import get_config
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.step import metrics_to_host

    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              num_layers=ABFT_LAYERS)
    L = cfg.num_layers
    state = init_state(cfg, seed=seed, device="cuda")
    data = make_pipeline(cfg, TRAIN_SEQ, 1, seed=seed)
    batches = [data.peek_batch(i) for i in range(ABFT_STEPS)]
    reset_detections()
    grad_check = _abft_grad_check(cfg, state["params"], batches[0])
    found = detections("cuda")
    if found:
        raise AssertionError(f"ABFT flagged {found} products of a clean "
                             "backward")
    runs, step_fns = {}, {}
    for impl in (None, "abft"):
        step_fn = step_fns[impl] = make_train_step(
            cfg, total_steps=ABFT_STEPS, impl=impl)
        if impl == "abft":
            counters = _counters()
            for fn in counters.values():
                fn.launches = 0
            abft_matmul_ext.tc_launches = 0
            reset_detections()
        st, losses, ms = state, [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = step_fn(st, b)
            losses.append(metrics_to_host(m)["loss"])
            ms.append((time.perf_counter() - t0) * 1e3)
        again, m2 = step_fn(state, batches[0])      # the first step again
        first, _ = step_fn(state, batches[0])
        runs[impl] = (losses, ms, metrics_to_host(m2)["loss"],
                      _tree_equal(again, first))
        del st, again, first
    launches = {k: fn.launches for k, fn in counters.items()}
    calls = ABFT_STEPS + 2
    want = {**_train_launches(L, 1, calls), "paged_attention": 0,
            "ckpt_quantize": 0, "ckpt_dequantize": 0, "block_hash": 0,
            "abft_matmul": calls * L * 7 * 4}
    if launches != want:
        raise AssertionError(f"ABFT steps: launches {launches}, the path "
                             f"implies {want}")
    tc_launches = abft_matmul_ext.tc_launches
    if tc_launches != want["abft_matmul"]:
        raise AssertionError(f"ABFT steps: {tc_launches} of "
                             f"{want['abft_matmul']} abft_matmul launches "
                             "took the tensor-core route")
    plain, abft = runs[None], runs["abft"]
    for a, b in zip(abft[0], plain[0]):
        if not abs(a - b) <= BF16_TOL * max(1.0, abs(b)):
            raise AssertionError(f"ABFT losses {abft[0]} vs plain "
                                 f"{plain[0]}")
    if not (abft[3] and abft[2] == abft[0][0]):
        raise AssertionError("two identical ABFT steps differ")
    found = detections("cuda")
    if found:
        raise AssertionError(f"ABFT flagged {found} products of clean steps")
    # one step of each, profiled: eager (host clock) and device time, and
    # the device time by kernel group (ABFT's kernels, the verifier's
    # reductions among "other")
    prof = {("abft" if impl else "plain"): profile_step(
        lambda f=f: f(state, batches[0]), calls=1)
        for impl, f in step_fns.items()}
    emit({"phase": "train-abft", "arch": cfg.name, "layers": L,
          "seq": TRAIN_SEQ, "batch": 1, "abft_losses": abft[0],
          "plain_losses": plain[0], "abft_step_ms": abft[1],
          "plain_step_ms": plain[1], "detections": found,
          "identical_steps_bit_equal": True, "launches": launches,
          "abft_tc_launches": tc_launches,
          "profiled": {k: {"wall_ms": v["wall_ms"],
                           "device_ms": v["device_ms"],
                           "device_ms_by_group": v["device_ms_by_group"],
                           "top_kernels_ms": v["top_kernels_ms"]}
                       for k, v in prof.items()},
          "grads": grad_check})
    del state
    torch.cuda.empty_cache()
    return launches


def phase_train_ssm(seed: int):
    """falcon-mamba-7b at full width (depth cut to SSM_TRAIN_LAYERS)
    trained through the facade: two identical steps bit-equal, the step's
    eager and device time, a protected run with raw async saves bit-equal
    to an uninterrupted run, then the train phase's protected run (the
    int8 device codec, async saves every 2, a fail-stop at step 5) with
    the launch counters held to the path."""
    from repro_torch.data import make_pipeline
    from repro_torch.launch.profile_steps import profile_step
    from repro_torch.models import get_config
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.step import metrics_to_host
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                              num_layers=SSM_TRAIN_LAYERS)
    L = cfg.num_layers
    tmp = tempfile.mkdtemp(dir=_ckpt_root())
    try:
        torch.cuda.reset_peak_memory_stats()
        state = init_state(cfg, seed=seed, device="cuda")
        n_params = sum(t.numel() for t in leaves(state["params"]))
        eligible = sum(1 for t in leaves(state)
                       if t.is_floating_point() and t.numel() >= 1024)
        step_fn = make_train_step(cfg, microbatches=TRAIN_MICRO,
                                  total_steps=TRAIN_STEPS)

        def pipeline():
            return make_pipeline(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=seed)

        batch = pipeline().peek_batch(0)
        s1, m1 = step_fn(state, batch)
        h1 = metrics_to_host(m1)
        t0 = time.perf_counter()
        s2, m2 = step_fn(state, batch)
        h2 = metrics_to_host(m2)
        eager_ms = (time.perf_counter() - t0) * 1e3
        same = _tree_equal(s1, s2)
        if not (same and h1["loss"] == h2["loss"]
                and h1["grad_norm"] == h2["grad_norm"]
                and math.isfinite(h1["loss"])):
            raise AssertionError(f"train-ssm: two identical steps differ: "
                                 f"{h1} vs {h2}, states equal: {same}")
        emit({"phase": "train-ssm", "check": "two identical steps",
              "loss": [h1["loss"], h2["loss"]],
              "grad_norm": [h1["grad_norm"], h2["grad_norm"]],
              "states_bit_equal": same})
        del s1, s2, m1, m2
        prof = profile_step(lambda: step_fn(state, batch), calls=1)
        groups = prof["device_ms_by_group"]
        tokens = TRAIN_BATCH * TRAIN_SEQ
        emit({"phase": "train-ssm", "check": "step", "arch": cfg.name,
              "layers": L, "d_model": cfg.d_model, "d_inner": cfg.d_inner,
              "ssm_state": cfg.ssm_state, "params": n_params,
              "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
              "microbatches": TRAIN_MICRO, "eager_ms": eager_ms,
              "profiled_wall_ms": prof["wall_ms"],
              "device_ms": prof["device_ms"],
              "host_share": 1.0 - prof["device_ms"] / eager_ms,
              "tokens_per_s": tokens / (eager_ms / 1e3),
              "kernels_per_step": prof["kernels_per_call"],
              "device_ms_by_group": groups,
              "launches_by_group": prof["launches_by_group"],
              "scan_fwd_ms": groups.get("selective_scan", 0.0),
              "scan_bwd_ms": groups.get("selective_scan_bwd", 0.0),
              "top_kernels_ms": prof["top_kernels_ms"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

        # the uninterrupted run, kept on the host
        ref, data = state, pipeline()
        for _ in range(TRAIN_STEPS):
            ref, _ = step_fn(ref, data.next_batch())
        ref = _tree_to(ref, "cpu")
        counters = _counters()
        runs = {}
        for label, config in (("raw", {"keep": 2}),
                              ("device_int8", {"device_codec": True})):
            run_dir = tempfile.mkdtemp(dir=tmp)
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            out, info, dep, calls, metrics = _protected_run(
                state, pipeline(), step_fn, run_dir, steps=TRAIN_STEPS,
                fail_at=TRAIN_FAIL, async_save=True, **config)
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            saves, restores = len(dep.save_history), len(dep.restore_seconds)
            codec = label == "device_int8"
            want = {**_train_launches(L, TRAIN_MICRO, calls, ssm=True),
                    "paged_attention": 0, "block_hash": 0,
                    "abft_matmul": 0,
                    "ckpt_quantize": eligible * saves if codec else 0,
                    "ckpt_dequantize": eligible * restores if codec else 0}
            if launches != want or min(launches[k] for k in want
                                       if want[k]) <= 0:
                raise AssertionError(f"train-ssm {label}: launches "
                                     f"{launches}, the path implies {want}")
            if int(out["step"]) != TRAIN_STEPS:
                raise AssertionError(f"train-ssm {label}: ended at step "
                                     f"{int(out['step'])}")
            bit_equal = _tree_equal(_tree_to(out, "cpu"), ref)
            if label == "raw" and not bit_equal:
                raise AssertionError("train-ssm: the recovered run's state "
                                     "differs from the uninterrupted run's")
            emit({"phase": "train-ssm", "check": f"protected run, {label}",
                  "status": info["status"], "restarts": info["restarts"],
                  "events": [h["event"] for h in info["history"]
                             if "event" in h],
                  "train_step_calls": calls,
                  "steps_losses": [(m["step"], m["loss"]) for m in metrics],
                  "recovered_bit_equal_to_uninterrupted": bit_equal,
                  "wall_s": wall,
                  "saves": [{"step": st.step, "bytes": st.bytes_written,
                             "snapshot_s": st.snapshot_seconds,
                             "write_s": st.write_seconds}
                            for st in dep.save_history],
                  "restore_s": dep.restore_seconds,
                  "eligible_leaves": eligible, "launches": launches,
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
            runs[label] = launches
            del out
            shutil.rmtree(run_dir, ignore_errors=True)
        del state, ref
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return runs["device_int8"]


def phase_tiny_fwi():
    """tests/test_torch_fwi.py's FWI (50 x 50, nt 300, 2 shots, 6
    iterations) in float32 on the card and on the CPU from the same
    observed data: the misfits within 1e-4 relative, the models within 1
    m/s where the CPU's first gradient is at least 1e-6 of its largest
    (elsewhere 2 lr an iteration: Adam's step amplifies rounding where
    the gradient is near 0), as the tests hold the port to the
    reference."""
    from repro_torch.apps.fwi import (FWIConfig, fwi_value_and_grad,
                                      init_fwi_state, make_observed_data,
                                      run_fwi)

    cfg = FWIConfig(**TINY_FWI)
    d_obs = make_observed_data(cfg, "cpu")["baseline"]
    runs = {}
    for device in ("cpu", "cuda"):
        st, hist = run_fwi(cfg, d_obs, device=device)
        runs[device] = (st["params"]["c"].cpu(), [h["loss"] for h in hist])
    _, g = fwi_value_and_grad(init_fwi_state(cfg, "cpu")["params"]["c"],
                              d_obs, cfg)
    quiet = g.abs() < 1e-6 * g.abs().max()
    diff = (runs["cuda"][0] - runs["cpu"][0]).abs()
    card, cpu = runs["cuda"][1], runs["cpu"][1]
    near = diff[~quiet].max().item()
    far = diff[quiet].max().item() if quiet.any() else 0.0
    if not (all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(card, cpu))
            and near <= 1.0 and far <= 2 * cfg.lr * cfg.iterations
            and card[-1] < 0.5 * card[0]):
        raise AssertionError(f"tiny-fwi: card misfits {card} vs CPU {cpu}, "
                             f"max |dc| {near} (quiet cells {far})")
    emit({"phase": "tiny-fwi", "grid": [cfg.nz, cfg.nx], "nt": cfg.nt,
          "shots": cfg.n_shots, "iterations": cfg.iterations,
          "card_misfits": card, "cpu_misfits": cpu,
          "max_abs_dc_m_per_s": near, "quiet_cells": int(quiet.sum()),
          "max_abs_dc_quiet_cells": far})


def phase_fwi():
    """The paper's FWI case study at the Marmousi model's extent
    (FWI_SIZE, FWI_GROUP shots a pass): one iteration timed (eager and
    device ms, host share, peak memory); the main path, a baseline
    survey in local scope over FWI_WIDTH shot shards with async saves
    every iteration and a fail-stop at FWI_FAIL (launch counters zeroed
    before it: the path runs none of the port's kernels); then eq. 2's
    overhead for sync, async and async int8 saves every iteration, the
    median of FWI_RUNS runs each, whose final models must equal the
    unprotected run's bit for bit, as must the recovered run's state.
    Eq. 2 from the medians is marked unresolved where the runs of every
    configuration spread more than it; the saves' held share is its
    estimate."""
    from repro_torch.apps.fwi import (FWIConfig, init_fwi_state,
                                      make_fwi_step, make_observed_data)
    from repro_torch.apps.fwi_case_study import (SAVE_CONFIGS, overhead,
                                                 survey)
    from repro_torch.launch.profile_steps import profile_step

    cuda = torch.device("cuda")
    cfg = FWIConfig(**FWI_SIZE, iterations=FWI_ITERS)
    groups = -(-cfg.n_shots // FWI_GROUP)
    t0 = time.perf_counter()
    d_obs = make_observed_data(cfg, cuda, shot_group=FWI_GROUP)["baseline"]
    torch.cuda.synchronize()
    synth_s = time.perf_counter() - t0
    step = make_fwi_step(cfg, FWI_GROUP)
    state = init_fwi_state(cfg, cuda)
    batch = {"d_obs": d_obs}
    # a warm-up call, then one under the profiler (the card's activity)
    prof = profile_step(lambda: step(state, batch), calls=1, host=False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, m = step(state, batch)
    float(m["loss"])
    eager_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    device_ms = prof["device_ms"]
    emit({"phase": "fwi", "check": "iteration", "grid": [cfg.nz, cfg.nx],
          "dx_m": cfg.dx, "nt": cfg.nt, "dt_s": cfg.dt, "f0_hz": cfg.f0,
          "shots": cfg.n_shots, "shot_group": FWI_GROUP,
          "shot_groups": groups,
          "cut": "16 shots (the paper spread 50 over 32 cores): this "
                 "script's time limit",
          "observed_data_s": synth_s, "eager_ms": eager_ms,
          "device_ms": device_ms, "host_share": 1.0 - device_ms / eager_ms,
          "kernels_per_iteration": prof["kernels_per_call"],
          "top_kernels_ms": prof["top_kernels_ms"],
          "peak_mem_gb": peak_gb,
          "saved_field_gb_per_shot": cfg.nz * cfg.nx * 4 * cfg.nt / 1e9})
    if groups < 2:
        raise AssertionError("fwi: the shots must run in 2 groups or more")

    # the main path, counters zeroed just before it
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    losses = []
    tmp = tempfile.mkdtemp(dir=_ckpt_root())
    try:
        t0 = time.perf_counter()
        run = survey(cfg, d_obs, dp_width=FWI_WIDTH, fail_at=FWI_FAIL,
                     device=cuda, ckpt_dir=tmp, shot_group=FWI_GROUP,
                     on_metrics=lambda st, rec: losses.append(
                         (st, rec["loss"])))
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    if any(launches.values()):
        raise AssertionError(f"fwi: launches {launches}; the FWI path runs "
                             "none of the port's kernels")
    if (run["events"] != ["failure:fail-stop"]
            or len(run["shard_files"]) != FWI_WIDTH
            or len(run["remapped"]["spans"]) != max(1, FWI_WIDTH // 2)
            or int(run["state"]["step"]) != FWI_ITERS):
        raise AssertionError(f"fwi: protected run {run['events']}, shard "
                             f"files {run['shard_files']}, remapped "
                             f"{run['remapped']}")
    if not losses[-1][1] < losses[0][1]:
        raise AssertionError(f"fwi: the misfit did not fall: {losses}")

    # eq. 2, and the unprotected run the recovered one must equal
    report, base = overhead(cfg, d_obs, runs=FWI_RUNS, device=cuda,
                            shot_group=FWI_GROUP, ckpt_root=str(_ckpt_root()))
    recovered_equal = _tree_equal(run["state"], base)
    if not (recovered_equal and all(report[k]["c_bit_equal"] for k in report
                                    if isinstance(report[k], dict)
                                    and "c_bit_equal" in report[k])):
        raise AssertionError(f"fwi: recovered state equal: "
                             f"{recovered_equal}; {report}")
    emit({"phase": "fwi", "check": "protected run",
          "status": "done", "events": run["events"],
          "dp_width": FWI_WIDTH, "shard_files": run["shard_files"],
          "shard_spans": run["spans"], "remapped": run["remapped"],
          "fail_stop_at": FWI_FAIL, "iterations": FWI_ITERS,
          "misfits": losses, "wall_s": run["wall_s"],
          "recovered_bit_equal_to_unprotected": recovered_equal,
          "launches": launches})
    # the runs spread more than the saves cost: eq. 2 is read as the share
    # the saves held the loop, within the bound an async writer's time
    # beside it sets; eq. 2 from the medians where it clears the spread
    emit({"phase": "fwi", "check": "overhead (paper eq. 2)",
          "eq2_estimate": {k: report[k]["held_share"] for k in SAVE_CONFIGS},
          "eq2_bound": {k: report[k]["eq2_bound"] for k in SAVE_CONFIGS},
          "eq2_raw": {k: (report[k]["eq2_raw"] if report[k]["eq2_resolved"]
                          else "unresolved") for k in SAVE_CONFIGS},
          **report})
    del run, base, d_obs, state
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# slice 8: MoE serving, elastic meshes over ranks, the compressed reduction
# --------------------------------------------------------------------------

# serve-moe: mixtral-8x7b at full width, depth cut to 4 of 32 layers
# (2.90 GB of bf16 a layer: 32 need 93.6 GB)
MOE_SERVE_LAYERS = 4
MOE_LM_BATCH = 8                 # the launch/serve_lm twin: 8 x 256, 32 new
# elastic: granite-3-8b at full width, 1 of 40 layers (2 until the chaos
# phases needed the time), on 2 hosts x 2 ranks
ELASTIC_LAYERS = 1
ELASTIC_SEQ = 1024
ELASTIC_BATCH = 8
ELASTIC_STEPS = 7
ELASTIC_KILL = 3                 # host 1's beats stop after this step
ELASTIC_BACK = 5                 # and start again after this one
# elastic-moe: mixtral-8x7b at full width, 1 of 32 layers, (2, 2, 2) over
# 4 hosts x 2 ranks; each rank's 4 rows in 4 microbatches (8 ranks share
# the card and each keeps its own allocator's peak; the weights are
# gathered once a step whatever the microbatches)
EMOE_LAYERS = 1
EMOE_STEPS = 5
EMOE_KILL = 3
EMOE_MICRO = 4
HEARTBEAT = 0.05                 # s; the monitor's timeout is 40 periods
# the mesh runs against a single-rank run at the same learning rate, at
# its peak from step 1 (no warm-up): each step's loss within
# ELASTIC_LOSS_TOL of the reference's, its gradient norm within
# ELASTIC_GNORM_RTOL of it, and the change that the step makes to the
# parameters' sum of squares (float64) within ELASTIC_UPDATE_RTOL of the
# reference step's change, relative to the reference's mean change a step
# (a step that updates nothing, or applies another update, misses it)
ELASTIC_WARMUP = 0
ELASTIC_LOSS_TOL = 1e-2
ELASTIC_GNORM_RTOL = 1e-2
ELASTIC_UPDATE_RTOL = 1e-2
# compress: one granite-3-8b layer's gradient leaves on 2 ranks, 8 rounds
COMPRESS_RANKS = 2
COMPRESS_ROUNDS = 8
_HASH_MOD = 2 ** 31 - 1


TINY_FAMILY_ENGINES = ("gemma-7b", "recurrentgemma-2b",
                       "phi3.5-moe-42b-a6.6b", "qwen1.5-110b")


def _vl_inputs(cfg, B, text, grid, tail, steps, seed):
    """qwen2-vl's inputs on the CPU, float32: embeddings (B, S, D) of
    ``text`` text positions, a grid x grid patch image at one temporal
    step and ``tail`` text positions, their (3, B, S) M-RoPE ids (the
    image's rows and columns from the text's end, the text after it from
    the largest id + 1), and ``steps`` decode embeddings with their ids."""
    g = torch.Generator().manual_seed(seed)
    ids = _vl_ids(B, text, grid, tail + steps)
    S = text + grid * grid + tail
    emb = torch.randn(B, S + steps, cfg.d_model, generator=g)
    return emb, ids, S


def _vl_ids(B, text, grid, tail):
    """(3, B, text + grid^2 + tail) int32 M-RoPE ids: ``text`` text
    positions, a grid x grid patch image at one temporal step (rows and
    columns from the text's end), then ``tail`` text positions from the
    largest id + 1."""
    t = torch.arange(text)
    hh, ww = torch.meshgrid(torch.arange(grid), torch.arange(grid),
                            indexing="ij")
    img = torch.stack([torch.full((grid * grid,), text), text + hh.reshape(-1),
                       text + ww.reshape(-1)])
    after = text + grid + torch.arange(tail)
    ids = torch.cat([torch.stack([t, t, t]), img,
                     torch.stack([after, after, after])], dim=1)
    return ids[:, None].expand(3, B, ids.shape[1]).to(torch.int32)


def _vl_decode(cfg, params, emb, ids, S, device):
    """Prefill the first S positions into a lockstep cache, then decode
    the rest one a step (the prefill and decode steps' model calls):
    the last-position logits of each call, float32, on the CPU."""
    from repro_torch.models import forward, init_cache

    B, T = emb.shape[:2]
    emb, ids = emb.to(device), ids.to(device)
    cache = init_cache(cfg, B, T, device)
    out = []
    with torch.no_grad():
        logits, cache = forward(cfg, params, {"embeddings": emb[:, :S],
                                              "positions": ids[:, :, :S]},
                                mode="prefill", cache=cache)
        out.append(logits[:, -1].float())
        for i in range(S, T):
            logits, cache = forward(
                cfg, params, {"embeddings": emb[:, i:i + 1],
                              "positions": ids[:, :, i:i + 1]},
                mode="decode", cache=cache)
            out.append(logits[:, 0].float())
    return [x.cpu() for x in out]


def _largest_gap(name, got, want, tol):
    """Raises unless |got - want| <= tol * max |want|; returns the max abs
    error over its bound."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    bound = tol * want.abs().max().item()
    err = (got - want).abs().max().item()
    if err > bound:
        raise AssertionError(f"{name}: max abs error {err:.3g} beyond {tol} "
                             f"of the largest magnitude "
                             f"{want.abs().max().item():.3g}")
    return err / bound


def phase_tiny_families(seed: int):
    """``tiny-families``: each of the six new families' TINY configs in
    float32 on the card (kernels) against the port on the CPU (plain
    versions), one set of weights on both: gemma-7b, recurrentgemma-2b
    (RG-LRU and rolling LOCAL rows in the slot pool), phi3.5-moe and
    qwen1.5-110b through ``ServeEngine``, the greedy streams token for
    token; qwen2-vl-2b's prefill (text, an image's (t, h, w) ids, text)
    and decode steps, and hubert-xlarge's encoder forward, within 1e-4 of
    the largest magnitude."""
    from repro_torch.models import forward, get_config, init_params

    out = {"phase": "tiny-families"}
    for arch in TINY_FAMILY_ENGINES:
        cfg = dataclasses.replace(get_config(arch, tiny=True),
                                  dtype=torch.float32)
        cpu = init_params(cfg, seed=seed, device="cpu")
        gpu = _tree_to(cpu, "cuda")
        prompts = _prompts(cfg.vocab_size, seed, (16, 24, 32))
        kw = dict(replicas=1, max_len=48, max_active=4)
        want = _serve(cfg, cpu, prompts, 8, "cpu", **kw)
        got = _serve(cfg, gpu, prompts, 8, "cuda", **kw)
        if got["streams"] != want["streams"] or None in got["streams"]:
            raise AssertionError(f"tiny-families {arch}: float32 streams "
                                 f"differ between the card and the CPU:\n"
                                 f"{got['streams']}\n{want['streams']}")
        out[arch] = {"tokens": sum(len(x) for x in got["streams"]),
                     "streams_equal_cpu": True}
    cfg = dataclasses.replace(get_config("qwen2-vl-2b", tiny=True),
                              dtype=torch.float32)
    cpu = init_params(cfg, seed=seed, device="cpu")
    gpu = _tree_to(cpu, "cuda")
    emb, ids, S = _vl_inputs(cfg, 2, 8, 4, 4, 6, seed)
    want = _vl_decode(cfg, cpu, emb, ids, S, "cpu")
    got = _vl_decode(cfg, gpu, emb, ids, S, "cuda")
    out["qwen2-vl-2b"] = {"calls": len(got), "max_err_over_bound": max(
        _largest_gap(f"tiny-families qwen2-vl-2b call {i}", a, b, FP32_TOL)
        for i, (a, b) in enumerate(zip(got, want)))}
    cfg = dataclasses.replace(get_config("hubert-xlarge", tiny=True),
                              dtype=torch.float32)
    cpu = init_params(cfg, seed=seed, device="cpu")
    gpu = _tree_to(cpu, "cuda")
    x = torch.randn(2, 50, cfg.d_model,
                    generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        want = forward(cfg, cpu, {"embeddings": x}, mode="prefill")[0]
        got = forward(cfg, gpu, {"embeddings": x.cuda()},
                      mode="prefill")[0].cpu()
    out["hubert-xlarge"] = {"max_err_over_bound": _largest_gap(
        "tiny-families hubert-xlarge", got, want, FP32_TOL)}
    emit(out)


def _family_engine(arch, seed, counters, total):
    """One decoding family at full width through ``ServeEngine`` (see
    ``phase_serve_families``); returns what the phase's summary needs."""
    from repro_torch.models import REC, get_config, init_params
    from repro_torch.tree import leaves

    cfg = get_config(arch)
    rec = REC in cfg.layer_kinds()
    full_depth = arch in ("gemma-7b", "recurrentgemma-2b")
    if not full_depth:
        cfg = dataclasses.replace(cfg, num_layers=FAMILY_CUT_LAYERS)
    L = cfg.num_layers
    attn = sum(k != REC for k in cfg.layer_kinds())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size()
                     for t in leaves(params)) / 1e9
    prompts = _prompts(cfg.vocab_size, seed, PROMPT_LENS)
    gen = GEN if full_depth else FAMILY_GEN
    kw = {}
    if rec:
        # the slot pool: 2 replicas x 4 slots; one more request, past the
        # LOCAL layers' window of 2048
        g = torch.Generator().manual_seed(seed + 1)
        prompts = prompts + [torch.randint(0, cfg.vocab_size,
                                           (FAMILY_LONG_PROMPT,),
                                           generator=g).tolist()]
        kw = dict(max_len=FAMILY_LONG_PROMPT + gen, slots=4)
    ceiling = 0.98 * math.log(cfg.padded_vocab)
    runs = {}
    for kill in ((False, True) if rec else (False,)):
        label = "replica_kill" if kill else "fault_free"
        for fn in counters.values():
            fn.launches = 0
        res = _serve(cfg, params, prompts, gen, "cuda", kill=kill, **kw)
        launches = _serve_launches(f"serve-families {arch} {label}",
                                   counters, res, L, attn)
        for k, v in launches.items():
            total[k] += v
        emit({"phase": "serve-families", "arch": arch, "run": label,
              "layers": L, "d_model": cfg.d_model,
              "head_dim": cfg.resolved_head_dim,
              "q_heads": cfg.effective_num_heads,
              "kv_heads": cfg.num_kv_heads, "paged": res["paged"],
              "weights_gb": weights_gb, "weights_init_s": init_s,
              "requests": len(prompts),
              "prompt_lens": [len(p) for p in prompts], "gen": gen,
              **_serve_summary(res),
              "replica_failures": len(res["failures"]),
              "failure_reasons": [f["reason"] for f in res["failures"]],
              "sentinel_ceiling": ceiling, "launches": launches,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        if res["dropped"] or None in res["streams"]:
            raise AssertionError(f"serve-families {arch} {label}: dropped "
                                 f"{res['dropped']}")
        if kill != bool(res["failures"]) or len(res["failures"]) > 1:
            raise AssertionError(f"serve-families {arch} {label}: replica "
                                 f"failures {res['failures']} (a decode "
                                 f"sentinel trip, its ceiling {ceiling})")
        runs[label] = res
    if rec:
        a, b = runs["fault_free"]["streams"], runs["replica_kill"]["streams"]
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        if diff:
            raise AssertionError(f"serve-families {arch}: streams after "
                                 f"the kill differ for requests {diff}")
    phase_steps(cfg, params, seed, calls=5, rows=4 if rec else MAX_ACTIVE,
                phase="steps-families")
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash": launches["flash_attention"],
            "paged": launches["paged_attention"]}


def phase_serve_families(seed: int):
    """``serve-families``: the six new families at full width, random
    weights from ``seed``, one model at a time (each freed before the
    next), launch counters zeroed just before each run and held to its
    path after it.
      * gemma-7b (28 layers, 16 heads of 256): 2 paged replicas, the
        serve phase's 8 requests, 32 new, fault-free;
      * recurrentgemma-2b (26 layers: 18 RG-LRU, 8 LOCAL with 16 padded
        q heads of 256 over one kv head): the slot pool, 2 replicas x 4
        slots, the same 8 requests and one of FAMILY_LONG_PROMPT tokens,
        32 new; fault-free, then replica 1 killed at KILL_STEP: nothing
        dropped, the streams token-identical;
      * phi3.5-moe and qwen1.5-110b at FAMILY_CUT_LAYERS layers: 2 paged
        replicas, the 8 requests, FAMILY_GEN new, fault-free;
      * qwen2-vl-2b (28 layers): a batch of 2, prefill of VL_TEXT text
        embeddings, a VL_GRID x VL_GRID patch image with its (t, h, w)
        ids and VL_TAIL text embeddings, then VL_DECODE decode steps in
        bf16 (launches held, each step's logits within
        VL_BF16_DECODE_TOL of the largest magnitude of a full forward's
        last position: bf16 rounds 2-2.7 % of it away over 28 layers,
        with the plain attention too), then the same in float32 within
        1e-4;
      * hubert-xlarge (48 layers, 16 heads of 80): HUBERT_BATCH x
        HUBERT_FRAMES frames through the encoder, within 2e-2 of the
        largest magnitude of the same forward on the card through the
        plain attention in bf16, and within 1e-4 in float32.
    Every serving run drops nothing with the decode sentinel on at its
    defaults (a trip fails the run; each run prints its entropy beside
    the ceiling); the flash kernel must have launched at head_dim 256 and
    80 and the paged kernel at G hd 4096 (the only shapes of those
    models' runs).  Then ``steps-families``: a decode step and a prefill
    of each decoding family, eager against device time."""
    import repro_torch.models.transformer as tf
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import forward, get_config, init_params

    counters = {k: fn for k, fn in _counters().items()
                if k in ("rmsnorm", "flash_attention", "paged_attention",
                         "selective_scan")}
    total = dict.fromkeys(counters, 0)
    shapes = {}
    for arch in TINY_FAMILY_ENGINES:
        shapes[arch] = _family_engine(arch, seed, counters, total)

    # qwen2-vl-2b: prefill and decode steps over embeddings with M-RoPE
    cfg = get_config("qwen2-vl-2b")
    L = cfg.num_layers
    params = init_params(cfg, seed=seed, device="cuda")
    emb, ids, S = _vl_inputs(cfg, 2, VL_TEXT, VL_GRID, VL_TAIL, VL_DECODE,
                             seed)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    got = _vl_decode(cfg, params, emb, ids, S, "cuda")
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    want_l = {"rmsnorm": (2 * L + 1) * (1 + VL_DECODE), "flash_attention": L,
              "paged_attention": L * VL_DECODE, "selective_scan": 0}
    if launches != want_l:
        raise AssertionError(f"serve-families qwen2-vl-2b: launches "
                             f"{launches}, the path implies {want_l}")
    for k, v in launches.items():
        total[k] += v
    if not all(torch.isfinite(x).all() for x in got):
        raise AssertionError("serve-families qwen2-vl-2b: non-finite logits")
    bf16_worst = max(
        _largest_gap(f"serve-families qwen2-vl-2b bf16 decode step {i + 1}",
                     g, w, VL_BF16_DECODE_TOL)
        for i, (g, w) in enumerate(_full_gap(cfg, params, emb, ids, S, got)))
    decode_ms = _vl_step_ms(cfg, params, emb, ids, S)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # the decode against the full forward at full width in float32, held
    # tightly (in bf16 a 28-layer stack drifts 1.6-2.7 % of the largest
    # logit whatever the attention, the inputs or the products' shape:
    # PERF.md §7, scripts/decode_gap.py)
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = init_params(f32, seed=seed, device="cuda")
    got = _vl_decode(f32, params, emb, ids, S, "cuda")
    gaps = _full_gap(f32, params, emb, ids, S, got)
    worst = max(_largest_gap(f"serve-families qwen2-vl-2b float32 decode "
                             f"step {i + 1}", g, w, FP32_TOL)
                for i, (g, w) in enumerate(gaps))
    emit({"phase": "serve-families", "arch": cfg.name, "layers": L,
          "d_model": cfg.d_model, "q_heads": cfg.effective_num_heads,
          "kv_heads": cfg.num_kv_heads, "batch": 2, "prefill_len": S,
          "image_grid": VL_GRID, "decode_steps": VL_DECODE,
          "wall_s": wall, "launches": launches,
          "bf16_decode_gap_of_max": bf16_worst * VL_BF16_DECODE_TOL,
          "bf16_max_err_over_bound": bf16_worst,
          "bf16_tol": VL_BF16_DECODE_TOL,
          "float32_max_err_over_bound": worst, "float32_tol": FP32_TOL})
    emit({"phase": "steps-families", "arch": cfg.name, "decode_rows": 2,
          **decode_ms})
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # hubert-xlarge: the encoder forward, against the plain attention, in
    # bf16 (the served dtype, launches held) and in float32 (the hd-80
    # kernel held tightly: bf16 over 48 layers reads 1.7 % of its 2 %)
    cfg = get_config("hubert-xlarge")
    L = cfg.num_layers
    x = torch.randn(HUBERT_BATCH, HUBERT_FRAMES, cfg.d_model,
                    generator=torch.Generator().manual_seed(seed)).cuda()

    def kernel_and_plain(cfg):
        params = init_params(cfg, seed=seed, device="cuda")
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = forward(cfg, params, {"embeddings": x}, mode="prefill")[0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            kernel_attention = tf.flash_attention
            tf.flash_attention = flash_attention_ref
            try:
                want = forward(cfg, params, {"embeddings": x},
                               mode="prefill")[0]
            finally:
                tf.flash_attention = kernel_attention
        del params
        return got, want, wall, launches

    f32_got, f32_want = kernel_and_plain(
        dataclasses.replace(cfg, dtype=torch.float32))[:2]
    f32_gap = _largest_gap("serve-families hubert-xlarge float32", f32_got,
                           f32_want, FP32_TOL)
    del f32_got, f32_want
    gc.collect()
    torch.cuda.empty_cache()
    for fn in counters.values():
        fn.launches = 0
    got, want, wall, launches = kernel_and_plain(cfg)
    want_l = {"rmsnorm": 2 * L + 1, "flash_attention": L,
              "paged_attention": 0, "selective_scan": 0}
    if launches != want_l:
        raise AssertionError(f"serve-families hubert-xlarge: launches "
                             f"{launches}, the path implies {want_l}")
    for k, v in launches.items():
        total[k] += v
    gap = _largest_gap("serve-families hubert-xlarge", got, want, BF16_TOL)
    emit({"phase": "serve-families", "arch": cfg.name, "layers": L,
          "d_model": cfg.d_model, "head_dim": cfg.resolved_head_dim,
          "batch": HUBERT_BATCH, "frames": HUBERT_FRAMES, "wall_s": wall,
          "max_err_over_bound": gap, "tol": BF16_TOL,
          "float32_max_err_over_bound": f32_gap, "float32_tol": FP32_TOL,
          "launches": launches})
    shapes["hubert-xlarge"] = {"flash": launches["flash_attention"]}
    del got, want
    gc.collect()
    torch.cuda.empty_cache()
    seen = {"flash_hd256": shapes["gemma-7b"]["flash"],
            "flash_hd80": shapes["hubert-xlarge"]["flash"],
            "paged_group_4096": shapes["recurrentgemma-2b"]["paged"]}
    emit({"phase": "serve-families", "launched_at_new_shapes": seen})
    if min(seen.values()) <= 0:
        raise AssertionError(f"serve-families: a new shape never launched: "
                             f"{seen}")
    return total


TRAIN_FAMILIES = ("gemma-7b", "recurrentgemma-2b", "qwen2-vl-2b",
                  "hubert-xlarge", "phi3.5-moe-42b-a6.6b", "qwen1.5-110b")


def _family_batch(cfg, data, step, grid):
    """The pipeline's batch of ``step``; under M-RoPE its text ids give way
    to a grid x grid image's (t, h, w) ids after 64 text positions (32 at
    a short length), text after it."""
    batch = data.peek_batch(step)
    if cfg.mrope_sections:
        B, S = batch["targets"].shape
        text = min(64, (S - grid * grid) // 2)
        batch["positions"] = _vl_ids(B, text, grid, S - text - grid * grid)
    return batch


def phase_train_tiny_families(seed: int):
    """``train-tiny-families``: the six new families' TINY configs in
    float32, two steps of 2 microbatches from one state on the card
    (kernels) and on the CPU (plain versions): the losses within 1e-4
    relative; then tiny recurrentgemma (RG-LRU, its unstacked layout) as
    ``train-tiny`` runs granite: a fail-stop run with raw saves
    bit-equal to an uninterrupted card run."""
    from repro_torch.data import make_pipeline
    from repro_torch.models import get_config
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.step import metrics_to_host

    out = {"phase": "train-tiny-families"}
    for arch in TRAIN_FAMILIES:
        cfg = dataclasses.replace(get_config(arch, tiny=True),
                                  dtype=torch.float32)
        cpu_state = init_state(cfg, seed=seed, device="cpu")
        step_fn = make_train_step(cfg, total_steps=4, warmup_steps=1,
                                  microbatches=2)
        losses = {}
        for device in ("cpu", "cuda"):
            state = _tree_to(cpu_state, device)
            data = make_pipeline(cfg, 32, 4, seed=seed)
            losses[device] = []
            for i in range(2):
                state, m = step_fn(state, _family_batch(cfg, data, i, 3))
                losses[device].append(metrics_to_host(m)["loss"])
        for a, b in zip(losses["cuda"], losses["cpu"]):
            if not abs(a - b) <= 1e-4 * max(1.0, abs(b)):
                raise AssertionError(f"train-tiny-families {arch}: card "
                                     f"losses {losses['cuda']} vs CPU "
                                     f"{losses['cpu']}")
        out[arch] = {"card_losses": losses["cuda"],
                     "cpu_losses": losses["cpu"]}
    emit(out)
    phase_train_tiny(seed, "recurrentgemma-2b", "train-tiny-families")


# train-families: (arch, layers (None: all), sequence, batch,
# microbatches).  gemma-7b cut to 4 of 28 layers as the train phase cuts
# granite (28 layers of state and gradients, ~22 B a parameter, need
# ~188 GB); recurrentgemma-2b at one block of its 13-layer pattern (26
# layers: 2.96 B parameters, and the functional step holds the old state,
# the new one and the gradients, ~28 B a parameter, 83 GB) at S 4096,
# past its window of 2048; hubert-xlarge and qwen2-vl-2b at full depth
TRAIN_FAMILY_RUNS = (
    ("gemma-7b", TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO),
    ("recurrentgemma-2b", 13, 2 * TRAIN_SEQ, 2, 2),
    ("hubert-xlarge", None, HUBERT_FRAMES, HUBERT_BATCH, 2),
    ("qwen2-vl-2b", None, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO),
)
# one microbatch's bf16 gradients through the kernels, each leaf's
# relative L2 from the float32 model's, against the same through the plain
# attention: both paths sit 1.4-4.7 % from float32 and 1.4-4.1 % from one
# another at these depths (PERF.md §6, PR 27 call 4), the kernels' error
# over the plain's 0.99-1.01 (median), 1.19 at most; the bound is the
# repo's bf16 rule (tests/test_torch_train.py)
FAMILY_GRAD_RATIO = 1.25


def _digest(tree):
    """Each leaf's bits reduced to two int64 sums (of its 32-bit words,
    and of each word times its position), in chunks: a step's state
    compared with another's without keeping both on the card."""
    from repro_torch.tree import leaves

    out = []
    chunk = 1 << 26
    for t in leaves(tree):
        w = t.detach().reshape(-1)
        w = (w.view(torch.int32) if w.element_size() == 4
             else w.to(torch.int32))
        a = b = 0
        for lo in range(0, w.numel(), chunk):
            c = w[lo:lo + chunk].to(torch.int64)
            idx = torch.arange(lo + 1, lo + 1 + c.numel(), device=c.device,
                               dtype=torch.int64)
            a += int(c.sum())
            b += int((c * idx).sum())
        out.append((a, b))
    return out


def _family_grads(cfg, params, batch):
    """The float32 gradients of the train loss on ``batch``."""
    from repro_torch.train import loss_fn
    from repro_torch.tree import leaves, unflatten

    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, _ = loss_fn(cfg, unflatten(params, live), batch)
    return torch.autograd.grad(loss, live)


def phase_train_families(seed: int):
    """``train-families``: TRAIN_FAMILY_RUNS at full width, random weights
    from ``seed``, one model at a time (each freed before the next),
    bf16 compute over float32 master weights, through ``init_state`` and
    ``make_train_step``: two identical steps from one state bit-equal
    (loss, grad norm and every state leaf's digest), the launch counters
    zeroed just before them and held to the path after them (an RG-LRU
    layer: 2 RMSNorms and no attention); the step's eager and device ms,
    tokens/s and peak memory; one microbatch's bf16 gradients through
    the kernels as close to the float32 model's (relative L2, each leaf)
    as the same gradients through the plain attention, within
    FAMILY_GRAD_RATIO, and the padded q heads' rows of wq, bq and wo
    exactly 0.  qwen2-vl-2b's positions carry
    a 24 x 24 image's (t, h, w) ids."""
    import repro_torch.models.transformer as tf
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch.profile_steps import profile_step
    from repro_torch.models import REC, get_config
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.step import metrics_to_host, split_microbatches
    from repro_torch.tree import flatten_named, leaves

    counters = _counters()
    total = dict.fromkeys(counters, 0)
    for arch, layers, S, B, micro in TRAIN_FAMILY_RUNS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        L = cfg.num_layers
        rec = sum(k == REC for k in cfg.layer_kinds())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = init_state(cfg, seed=seed, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in leaves(state["params"]))
        step_fn = make_train_step(cfg, microbatches=micro, total_steps=4)
        batch = _family_batch(cfg, make_pipeline(cfg, S, B, seed=seed), 0,
                              VL_GRID)

        # the main path: two identical steps, counters zeroed before them
        for fn in counters.values():
            fn.launches = 0
        s1, m1 = step_fn(state, batch)
        h1 = metrics_to_host(m1)
        d1 = _digest(s1)
        del s1, m1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s2, m2 = step_fn(state, batch)
        h2 = metrics_to_host(m2)
        eager_ms = (time.perf_counter() - t0) * 1e3
        d2 = _digest(s2)
        del s2, m2
        launches = {k: fn.launches for k, fn in counters.items()}
        want = {k: 0 for k in counters}
        want.update(_train_launches(L, micro, 2, rec=rec))
        if launches != want:
            raise AssertionError(f"train-families {arch}: launches "
                                 f"{launches}, the path implies {want}")
        for k, v in launches.items():
            total[k] += v
        if not (d1 == d2 and h1["loss"] == h2["loss"]
                and h1["grad_norm"] == h2["grad_norm"]
                and math.isfinite(h1["loss"])):
            raise AssertionError(f"train-families {arch}: two identical "
                                 f"steps differ: {h1} vs {h2}, states "
                                 f"equal: {d1 == d2}")
        step_peak = torch.cuda.max_memory_allocated() / 1e9
        # the two steps above warmed it up
        prof = profile_step(lambda: step_fn(state, batch), calls=1,
                            host=False, warm=True)
        groups = prof["device_ms_by_group"]

        # one microbatch's bf16 gradients through the kernels and through
        # the plain attention, each against the float32 model's
        mb = split_microbatches({k: v.cuda() for k, v in batch.items()},
                                micro)[0]
        names = [n for n, _ in flatten_named(state["params"])]
        got = _family_grads(cfg, state["params"], mb)
        kernel_attention = tf.flash_attention
        tf.flash_attention = flash_attention_ref
        try:
            plain = _family_grads(cfg, state["params"], mb)
        finally:
            tf.flash_attention = kernel_attention
        truth = _family_grads(dataclasses.replace(cfg, dtype=torch.float32),
                              state["params"], mb)

        def rel(a, b):
            return ((a.float() - b.float()).norm()
                    / b.float().norm().clamp_min(1e-30)).item()

        grads = {"kernels_vs_plain": 0.0, "kernels_vs_float32": 0.0,
                 "plain_vs_float32": 0.0, "ratio": 0.0}
        for n, a, b, t in zip(names, got, plain, truth):
            ek, ep = rel(a, t), rel(b, t)
            if not (torch.isfinite(a).all()
                    and ek <= FAMILY_GRAD_RATIO * ep + 1e-3):
                raise AssertionError(
                    f"train-families {arch}: gradient {n} {ek:.3g} from "
                    f"float32 through the kernels, {ep:.3g} through the "
                    f"plain attention (relative L2; limit "
                    f"{FAMILY_GRAD_RATIO}x + 1e-3)")
            for k, v in (("kernels_vs_plain", rel(a, b)),
                         ("kernels_vs_float32", ek),
                         ("plain_vs_float32", ep),
                         ("ratio", ek / max(ep, 1e-30))):
                grads[k] = max(grads[k], v)
        del plain, truth
        he, kv = cfg.effective_num_heads, cfg.num_kv_heads
        pad = [h for h in range(he)
               if h % (he // kv) >= cfg.num_heads // kv]
        padded = 0
        for n, g in zip(names, got):
            axis = {"wq": -2, "bq": -2, "wo": -3}.get(n.rsplit(".", 1)[-1])
            if axis is not None and pad:
                if g.index_select(axis % g.dim(), torch.tensor(
                        pad, device=g.device)).any():
                    raise AssertionError(f"train-families {arch}: padded "
                                         f"heads of {n} have gradients")
                padded += 1
        del got
        tokens = B * S
        emit({"phase": "train-families", "arch": cfg.name, "layers": L,
              "rec_layers": rec, "d_model": cfg.d_model,
              "head_dim": cfg.resolved_head_dim,
              "q_heads": cfg.effective_num_heads, "kv_heads": kv,
              "params": n_params, "init_s": init_s, "seq": S, "batch": B,
              "microbatches": micro,
              "loss": [h1["loss"], h2["loss"]],
              "grad_norm": [h1["grad_norm"], h2["grad_norm"]],
              "states_bit_equal": True, "eager_ms": eager_ms,
              "profiled_wall_ms": prof["wall_ms"],
              "device_ms": prof["device_ms"],
              "host_share": 1.0 - prof["device_ms"] / eager_ms,
              "tokens_per_s": tokens / (eager_ms / 1e3),
              "kernels_per_step": prof["kernels_per_call"],
              "device_ms_by_group": groups,
              "flash_fwd_ms": groups.get("flash_attention", 0.0),
              "flash_bwd_ms": groups.get("flash_attention_bwd", 0.0),
              "top_kernels_ms": prof["top_kernels_ms"],
              "grads_worst_rel_l2": grads,
              "grad_ratio_limit": FAMILY_GRAD_RATIO,
              "padded_heads": pad, "padded_leaves_zero": padded,
              "launches": launches, "step_peak_mem_gb": step_peak,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        del state, batch, mb
        gc.collect()
        torch.cuda.empty_cache()
    return total


def _full_gap(cfg, params, emb, ids, S, got):
    """(decode logits, the full forward's last position) for each decode
    step of ``_vl_decode``, float32 on the CPU."""
    from repro_torch.models import forward

    out = []
    with torch.no_grad():
        for i in range(1, len(got)):
            n = S + i
            full = forward(cfg, params, {"embeddings": emb[:, :n].cuda(),
                                         "positions": ids[:, :, :n].cuda()},
                           mode="prefill")[0][:, -1].float().cpu()
            out.append((got[i], full))
    return out


def _vl_step_ms(cfg, params, emb, ids, S):
    """qwen2-vl's decode step over its lockstep cache: eager ms (host
    clock to a synchronize) and device ms (the step in a CUDA graph)."""
    from repro_torch.models import forward, init_cache

    B, T = emb.shape[:2]
    cache = init_cache(cfg, B, T, "cuda")
    batch = {"embeddings": emb[:, S:S + 1].cuda(),
             "positions": ids[:, :, S:S + 1].cuda()}

    def step():
        cache["index"].fill_(S)
        return forward(cfg, params, batch, mode="decode", cache=cache)

    with torch.no_grad():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
            torch.cuda.synchronize()
        eager = (time.perf_counter() - t0) / 5 * 1e3
        device = time_ms(step, iters=2, reps=3)
    return {"decode_eager_ms": eager, "decode_device_ms": device,
            "decode_host_share": 1.0 - device / eager}


def phase_tiny_moe(seed: int):
    """``tiny-moe``: tiny mixtral in float32 on the card (kernels) and on
    the CPU (plain versions), one set of weights: the engine's greedy
    streams and the ``launch/serve_lm`` lockstep streams agree token for
    token."""
    from repro_torch.launch.serve_lm import generate
    from repro_torch.models import get_config, init_params

    cfg = dataclasses.replace(get_config("mixtral-8x7b", tiny=True),
                              dtype=torch.float32)
    cpu = init_params(cfg, seed=seed, device="cpu")
    gpu = _tree_to(cpu, "cuda")
    prompts = _prompts(cfg.vocab_size, seed, (16, 24, 32))
    kw = dict(replicas=1, max_len=48, max_active=4)
    want = _serve(cfg, cpu, prompts, 8, "cpu", **kw)
    got = _serve(cfg, gpu, prompts, 8, "cuda", **kw)
    if got["streams"] != want["streams"] or None in got["streams"]:
        raise AssertionError(f"tiny-moe: float32 streams differ between "
                             f"the card and the CPU:\n{got['streams']}\n"
                             f"{want['streams']}")
    g = torch.Generator().manual_seed(seed)
    batch = torch.randint(0, cfg.vocab_size, (4, 24), generator=g,
                          dtype=torch.int32)
    lm_cpu = generate(cfg, cpu, batch, 8, "cpu")["tokens"]
    lm_gpu = generate(cfg, gpu, batch.cuda(), 8, "cuda")["tokens"].cpu()
    if not torch.equal(lm_cpu, lm_gpu):
        raise AssertionError("tiny-moe: lockstep streams differ between "
                             "the card and the CPU")
    emit({"phase": "tiny-moe", "requests": len(prompts),
          "tokens": sum(len(s) for s in got["streams"]),
          "streams_equal_cpu": True, "lockstep_equal_cpu": True})


def phase_serve_moe(seed: int):
    """``serve-moe``: mixtral-8x7b at full width (MOE_SERVE_LAYERS of 32
    layers, random weights from ``seed``): the ``launch/serve_lm`` twin
    (8 prompts of 256 tokens in lockstep, 32 new), then ``ServeEngine``
    with 2 paged replicas serving the serve phase's 8 requests, fault-free
    and with replica 1 killed at engine step 5 (an MoE decode routes the
    whole batch as one token axis, so a retried request may lose or
    regain an expert slot: the streams are counted, not held equal; see
    ROADMAP), launches held to each path, the decode sentinel's entropy
    beside its ceiling, and ``steps-moe`` (a decode and a prefill step,
    eager against device time)."""
    from repro_torch.launch.serve_lm import generate
    from repro_torch.models import get_config, init_params

    cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                              num_layers=MOE_SERVE_LAYERS)
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    counters = {k: fn for k, fn in _counters().items()
                if k in ("rmsnorm", "flash_attention", "paged_attention",
                         "selective_scan")}
    g = torch.Generator().manual_seed(seed)
    batch = torch.randint(0, cfg.vocab_size, (MOE_LM_BATCH, 256),
                          generator=g, dtype=torch.int32).cuda()
    for fn in counters.values():
        fn.launches = 0
    lm = generate(cfg, params, batch, GEN, "cuda")
    lm_launches = {k: fn.launches for k, fn in counters.items()}
    want = {"rmsnorm": (2 * L + 1) * GEN, "flash_attention": L,
            "paged_attention": L * (GEN - 1), "selective_scan": 0}
    if lm_launches != want:
        raise AssertionError(f"serve-moe lockstep: launches {lm_launches}, "
                             f"the path implies {want}")
    if tuple(lm["tokens"].shape) != (MOE_LM_BATCH, GEN) or not bool(
            ((lm["tokens"] >= 0) & (lm["tokens"] < cfg.vocab_size)).all()):
        raise AssertionError("serve-moe lockstep: tokens out of range")
    emit({"phase": "serve-moe", "run": "lockstep", "arch": cfg.name,
          "layers": L, "d_model": cfg.d_model, "experts": cfg.num_experts,
          "top_k": cfg.experts_per_token, "batch": MOE_LM_BATCH,
          "prompt_len": 256, "gen": GEN, "prefill_ms": lm["prefill_s"] * 1e3,
          "decode_ms_per_step": lm["decode_s"] * 1e3 / (GEN - 1),
          "launches": lm_launches, "weights_init_s": init_s})
    prompts = _prompts(cfg.vocab_size, seed, PROMPT_LENS)
    ceiling = 0.98 * math.log(cfg.padded_vocab)
    runs = {}
    total = dict.fromkeys(counters, 0)
    for label, kill in (("fault_free", False), ("replica_kill", True)):
        for fn in counters.values():
            fn.launches = 0
        res = _serve(cfg, params, prompts, GEN, "cuda", kill=kill)
        launches = _serve_launches(f"serve-moe {label}", counters, res, L)
        for k, v in launches.items():
            total[k] += v
        if res["dropped"] or None in res["streams"]:
            raise AssertionError(f"serve-moe {label}: dropped "
                                 f"{res['dropped']}")
        if kill != bool(res["failures"]):
            raise AssertionError(f"serve-moe {label}: replica failures "
                                 f"{res['failures']}")
        runs[label] = res
        emit({"phase": "serve-moe", "run": label, **_serve_summary(res),
              "replica_failures": len(res["failures"]),
              "sentinel_ceiling": ceiling, "launches": launches,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        if max(res["entropy_ema"]) >= ceiling:
            raise AssertionError("serve-moe: decode entropy at the "
                                 "sentinel's ceiling")
    a, b = runs["fault_free"], runs["replica_kill"]
    differ = [i for i, (x, y) in enumerate(zip(a["streams"], b["streams"]))
              if x != y]
    emit({"phase": "serve-moe", "streams_differing_after_kill": differ,
          "retried": b["retried"]})
    phase_steps(cfg, params, seed, phase="steps-moe")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: lm_launches[k] + total[k] for k in counters}


def _pos_hash(x: torch.Tensor, spans, gshape) -> int:
    """A leaf shard's share of the leaf's position-weighted word hash
    mod 2^31 - 1 (each 32-bit word times 2 i + 1, i its flat index in
    the whole leaf): the shares of a leaf's shards add up to the same
    number on any mesh iff the leaf's bits are the same."""
    from repro_torch.kernels.block_hash.ref import words_view

    if x.ndim == 0:
        idx = torch.zeros((), dtype=torch.int64, device=x.device)
    else:
        strides = [1] * len(gshape)
        for d in range(len(gshape) - 2, -1, -1):
            strides[d] = strides[d + 1] * int(gshape[d + 1])
        idx = torch.zeros((1,) * x.ndim, dtype=torch.int64, device=x.device)
        for d, ((a, b), st) in enumerate(zip(spans, strides)):
            shape = [1] * x.ndim
            shape[d] = b - a
            idx = idx + (torch.arange(a, b, device=x.device) * st).view(shape)
    w = words_view(x).reshape(-1) % _HASH_MOD
    wt = ((2 * idx.reshape(-1) + 1) % _HASH_MOD).expand_as(w) \
        if idx.numel() == 1 else (2 * idx.reshape(-1) + 1) % _HASH_MOD
    return int(((w * wt) % _HASH_MOD).sum().item() % _HASH_MOD)


def _param_sq(params, own=None) -> torch.Tensor:
    """The sum of squares of the parameter leaves in float64 (only the
    leaves ``own`` marks, where given), a 0-dim tensor on their device."""
    from repro_torch.tree import leaves

    xs = leaves(params)
    own = [True] * len(xs) if own is None else own
    total = torch.zeros((), dtype=torch.float64, device=xs[0].device)
    for x, o in zip(xs, own):
        if o:
            total += x.detach().to(torch.float64).square_().sum()
    return total


def _state_hashes(state, shardings, like):
    """Every leaf's position hash over the mesh (each shard counted once,
    by its replica 0), the same on every rank of the mesh."""
    from repro_torch.sharding import comm
    from repro_torch.tree import flatten_named, leaves

    shs = leaves(shardings)
    mesh = shs[0].mesh
    parts = []
    for (_, x), sh, (_, g) in zip(flatten_named(state), shs,
                                  flatten_named(like)):
        own = sh.replica_id() == 0
        parts.append(_pos_hash(x, sh.spans(tuple(g.shape)), tuple(g.shape))
                     if own else 0)
    t = torch.tensor(parts, dtype=torch.int64)
    total = comm.ordered_sum(t, mesh.group(mesh.axis_names)) % _HASH_MOD
    return [int(v) for v in total]


def _rank_elastic(world, mode: str, ckpt: str, seed: int):
    """One rank of ``elastic`` (granite-3-8b, 2 hosts x 2 ranks, (2, 2),
    host 1's beats stop after ELASTIC_KILL steps and start again after
    ELASTIC_BACK) or ``elastic-moe`` (mixtral-8x7b, 4 hosts x 2 ranks,
    (2, 2, 2), experts degraded, host 1 killed after EMOE_KILL steps).
    Returns the rank's history, events, launches, step times, peak
    memory, the collectives' seconds and bytes, and the state hashes at
    each pause's save and each restore."""
    import json as _json

    from repro_torch.core import (Dependability, DependabilityConfig,
                                  HeartbeatEmitter, MeshSpec, run_elastic)
    from repro_torch.data import ShardedPipeline
    from repro_torch.launch.mesh import host_device_map
    from repro_torch.models import get_config
    from repro_torch.sharding import comm
    from repro_torch.train import init_state
    from repro_torch.train.mesh_step import (init_sharded_state,
                                             make_mesh_train_step,
                                             state_shardings)
    from repro_torch.tree import leaves

    moe = mode == "elastic-moe"
    cfg = dataclasses.replace(
        get_config("mixtral-8x7b" if moe else "granite-3-8b"),
        num_layers=EMOE_LAYERS if moe else ELASTIC_LAYERS)
    nh = 4 if moe else 2
    steps = EMOE_STEPS if moe else ELASTIC_STEPS
    kill_at = EMOE_KILL if moe else ELASTIC_KILL
    micro = EMOE_MICRO if moe else 1
    hosts = host_device_map(nh)
    r0 = world.rank == 0
    dep = Dependability(DependabilityConfig(
        checkpoint_dir=ckpt, policy_mode="every_n", every_n=10 ** 6,
        fsync="none", heartbeat=r0, heartbeat_period=HEARTBEAT,
        heartbeat_timeout_factor=40.0, signal_detection=False,
        monitor_hosts=nh)).start()
    if r0:
        world.publish("monaddr", _json.dumps(list(dep.monitor.addr)))
    addr = tuple(_json.loads(world.fetch("monaddr")))
    my_host = next(h for h, rs in hosts.items() if world.rank in rs)
    em = (HeartbeatEmitter(my_host, addr, HEARTBEAT).start()
          if hosts[my_host][0] == world.rank and my_host != 0 else None)
    like = init_state(cfg, seed=seed, device="meta")
    spec = (MeshSpec.from_config(cfg, data=2, model=2, expert=2)
            if moe else None)

    def shardings_for(mesh, dead=()):
        ep = mesh.shape.get("expert", 1)
        return state_shardings(cfg, mesh, moe_ep=(ep if ep > 1 else False))

    def make_step(mesh, dead=()):
        c = dataclasses.replace(cfg, dead_experts=tuple(dead))
        sh = shardings_for(mesh, dead)
        fn = make_mesh_train_step(c, mesh, sh, like,
                                  warmup_steps=ELASTIC_WARMUP,
                                  total_steps=steps, microbatches=micro,
                                  donate=True)
        own = [s.replica_id() == 0 for s in leaves(sh["params"])]
        group = mesh.group(mesh.axis_names)

        def param_sq(state):
            # each shard counted once, summed over the mesh in rank order
            rec["param_sq"].append([int(state["step"]), float(
                comm.ordered_sum(_param_sq(state["params"], own), group))])

        def step(state, batch):
            if not rec["param_sq"]:
                param_sq(state)              # the initial state
            state, m = fn(state, batch)
            param_sq(state)
            return state, m
        return step

    def init(mesh, sh):
        return init_sharded_state(cfg, sh, seed=seed, device=world.device,
                                  world=world, ranks=mesh.ranks())

    data = ShardedPipeline(cfg, ELASTIC_SEQ, ELASTIC_BATCH, dp_width=2)

    def wait_for(pred, what, timeout=120.0):
        t = time.monotonic()
        while not pred():
            if time.monotonic() - t > timeout:
                raise TimeoutError(f"rank {world.rank}: {what}")
            time.sleep(0.01)

    rec = {"saved": [], "restored": [], "step_s": [], "comm": [],
           "param_sq": []}
    mark = {"t": None}

    def on_metrics(s, r):
        rec["step_s"].append([s, r["seconds"]])
        rec["comm"].append(comm.stats())
        comm.reset_stats()
        if s == kill_at and not world.has("killed"):
            if em is not None and my_host == 1:
                em.pause()                   # host 1's fail-stop
            if r0:
                wait_for(lambda: 1 in dep.monitor.failed_hosts(),
                         "host 1's failure detected")
                world.publish("killed", "1")
        if (not moe and s == ELASTIC_BACK and r0
                and not world.has("resume")):
            world.publish("resume", "1")
            wait_for(lambda: world.has("resumed"), "host 1 resumed")
            wait_for(lambda: dep.on_host_rejoin.pending() == [1],
                     "host 1's rejoin detected")

    def on_idle():
        if (em is not None and world.has("resume")
                and not world.has("resumed")):
            em.resume()
            world.publish("resumed", "1")

    save, restore = dep.save, dep.restore_latest

    def hashed_save(step, state, **kw):
        out = save(step, state, **kw)
        if kw.get("final"):
            rec["saved"].append([step, _state_hashes(
                state, dep._global_shardings, like)])
        return out

    def hashed_restore(**kw):
        t = time.perf_counter()
        state, got = restore(**kw)
        torch.cuda.synchronize()
        rec["restored"].append([got, time.perf_counter() - t,
                                _state_hashes(state, kw["shardings"], like)])
        return state, got

    dep.save, dep.restore_latest = hashed_save, hashed_restore
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    comm.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, info = run_elastic(
        dep, make_step, init, data, steps, world=world, host_devices=hosts,
        model_axis=2, mesh_spec=spec, degrade_experts=moe, like=like,
        shardings_fn=shardings_for, on_metrics=on_metrics, on_idle=on_idle,
        control_timeout=600.0)
    wall = time.perf_counter() - t0
    if moe and state is not None:
        # a save on the survivor mesh: its manifest records that grid
        dep.save(steps, state)
    out = {"rank": world.rank, "status": info["status"],
           "events": [dataclasses.asdict(e) for e in info["events"]],
           "history": info["history"], "wall_s": wall,
           "launches": {k: fn.launches for k, fn in counters.items()},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "meta": dep.manager.manifest_meta(dep.manager.latest_step()),
           "member": state is not None, **rec}
    if em is not None:
        em.stop()
    dep.stop()
    return out


def _single_rank_run(cfg, steps, micro, seed, dead_at=None, dead=()):
    """The elastic runs' reference: an uninterrupted run on one rank of the
    same global batches at the same learning rate, its losses, gradient
    norms and the parameters' sums of squares (the initial one first);
    from step ``dead_at`` on the config degrades ``dead`` experts."""
    from repro_torch.data import ShardedPipeline
    from repro_torch.train import init_state, make_train_step

    data = ShardedPipeline(cfg, ELASTIC_SEQ, ELASTIC_BATCH, dp_width=1)
    kw = dict(warmup_steps=ELASTIC_WARMUP, total_steps=steps,
              microbatches=micro)
    live = make_train_step(cfg, **kw)
    degraded = make_train_step(dataclasses.replace(cfg, dead_experts=dead),
                               **kw)
    state = init_state(cfg, seed=seed, device="cuda")
    losses, norms, sq = [], [], [float(_param_sq(state["params"]))]
    for s in range(1, steps + 1):
        fn = degraded if dead_at is not None and s > dead_at else live
        state, m = fn(state, data.next_batch())
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        sq.append(float(_param_sq(state["params"])))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return losses, norms, sq


def _run_ranks(fn, n, args, timeout):
    """``sharding.launch.spawn`` with the card's memory handed back first
    (every rank keeps its own allocator) and expandable segments."""
    from repro_torch.sharding.launch import spawn

    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "ranks", "fn": fn.__name__, "ranks": n,
          "parent_allocated_gb": torch.cuda.memory_allocated() / 1e9,
          "parent_reserved_gb": torch.cuda.memory_reserved() / 1e9})
    prev = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    run_dir = tempfile.mkdtemp(dir=_ckpt_root(), prefix="ranks_")
    try:
        return spawn(fn, n, run_dir=run_dir, args=args, device="cuda",
                     join_timeout=timeout)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        if prev is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = prev


def _comm_totals(rec):
    tot = {}
    for snap in rec["comm"]:
        for op, v in snap.items():
            t = tot.setdefault(op, {"calls": 0, "seconds": 0.0, "bytes": 0})
            for k in t:
                t[k] += v[k]
    return tot


def _trajectory_gaps(steps, history, param_sq, ref, ref_norms, ref_sq):
    """A mesh run's surviving steps against the single-rank run's: each
    step's loss (absolute), gradient norm (relative) and change of the
    parameters' sum of squares (relative to the reference's mean change a
    step; a step run again after a restore: its last record counts).
    Returns the gaps and the names of the limits missed."""
    from repro_torch.chaos import invariants as inv

    losses = [h["loss"] for h in history if "loss" in h]
    norms = [h["grad_norm"] for h in history if "loss" in h]
    tm = inv.check_trajectory_match(losses, ref, tol=ELASTIC_LOSS_TOL)
    norm_gap = [abs(a - b) / b for a, b in zip(norms, ref_norms)]
    sq = dict((k, v) for k, v in param_sq)
    ref_d = [ref_sq[k] - ref_sq[k - 1] for k in range(1, steps + 1)]
    scale = sum(abs(d) for d in ref_d) / steps
    update_gap = [abs(sq.get(k, math.nan) - sq.get(k - 1, math.nan) - d)
                  / scale for k, d in enumerate(ref_d, 1)]
    bad = [] if bool(tm) else [f"trajectory {tm}"]
    if not max(norm_gap) <= ELASTIC_GNORM_RTOL:
        bad.append(f"gradient norms off the single-rank run's by {norm_gap}")
    if not all(g <= ELASTIC_UPDATE_RTOL for g in update_gap):
        bad.append(f"the steps' changes of the parameters' sum of squares "
                   f"off the single-rank run's by {update_gap} of them")
    return {"losses": losses, "grad_norms": norms,
            "trajectory_max_diff": max(abs(a - b)
                                       for a, b in zip(losses, ref)),
            "grad_norm_max_rel_diff": max(norm_gap),
            "param_sq": [sq.get(k) for k in range(steps + 1)],
            "update_rel_gap": update_gap}, bad


def phase_elastic(seed: int, mode: str):
    """``elastic`` / ``elastic-moe`` on ranks sharing the card (files over
    host memory: a collective's time here says nothing of a network's
    bandwidth).  Checks: the events, the survivor grid (and for MoE the
    degraded experts and the manifest's mesh) equal what ``best_grid3d``
    and ``largest_grid`` give; no step lost; every loss finite, and each
    step's loss and gradient norm within ELASTIC_LOSS_TOL (absolute) and
    ELASTIC_GNORM_RTOL (relative) of an uninterrupted single-rank run of
    the same batches at the same learning rate (MoE: degrading the same
    experts at the same step), and the change each step makes to the
    parameters' sum of squares within ELASTIC_UPDATE_RTOL (of that run's
    mean change a step) of the change that run's step makes (the loss
    moves too little on these random batches to show a step that updates
    nothing); the state's
    position hash at each pause's save equal to the hash of the shards
    restored from it (bit-equal, on another mesh); launches held to the
    path."""
    from repro_torch.chaos import invariants as inv
    from repro_torch.core import MeshSpec, best_grid3d, largest_grid
    from repro_torch.models import get_config

    moe = mode == "elastic-moe"
    n = 8 if moe else 4
    cfg = dataclasses.replace(
        get_config("mixtral-8x7b" if moe else "granite-3-8b"),
        num_layers=EMOE_LAYERS if moe else ELASTIC_LAYERS)
    steps = EMOE_STEPS if moe else ELASTIC_STEPS
    micro = EMOE_MICRO if moe else 1
    ckpt = tempfile.mkdtemp(dir=_ckpt_root(), prefix=mode + "_")
    t0 = time.perf_counter()
    try:
        out = _run_ranks(_rank_elastic, n, (mode, ckpt, seed), 900.0)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.perf_counter() - t0
    lead = out[0]
    kinds = [(e["kind"], tuple(e["hosts"]), (e["dp"], e["tp"], e["ep"]))
             for e in lead["events"]]
    if moe:
        spec = MeshSpec.from_config(cfg, data=2, model=2, expert=2)
        live = cfg.num_experts - cfg.num_experts // 2
        grid = best_grid3d(6, spec.with_experts(live))
        want = [("shrink", (1,), grid)]
        dead = list(range(cfg.num_experts // 2))
        want_meta = {"dp": grid[0], "tp": grid[1], "ep": grid[2],
                     "moe_ep": grid[2], "dead_experts": dead}
        deg = [h["event"] for h in lead["history"]
               if str(h.get("event", "")).startswith("degraded_experts")]
        want_deg = [f"degraded_experts:{','.join(map(str, dead))}"
                    f":live={live}"]
        if deg != want_deg:
            raise AssertionError(f"elastic-moe: degraded {deg}, want "
                                 f"{want_deg}")
    else:
        small = largest_grid(2, 2)
        want = [("shrink", (1,), (small[0], 1, 1)),
                ("grow", (1,), (largest_grid(4, 2)[0], 1, 1))]
        # the newest save is the grow's pause, taken on the shrunk mesh
        want_meta = {"dp": small[0], "tp": small[1], "ep": 1,
                     "moe_ep": False, "dead_experts": []}
    if kinds != want or lead["meta"] != want_meta:
        raise AssertionError(f"{mode}: events {kinds} meta {lead['meta']}, "
                             f"want {want} {want_meta}")
    for r in out:
        if r["status"] != "done" or r["events"] != lead["events"]:
            raise AssertionError(f"{mode}: rank {r['rank']} {r['status']} "
                                 f"{r['events']}")
    losses = [h["loss"] for h in lead["history"] if "loss" in h]
    lost = inv.check_no_lost_steps(lead["history"], steps)
    if not bool(lost) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{mode}: steps {lost} losses {losses}")
    # the pause's saves against the restores from them, on every rank
    saved = {s: h for s, h in lead["saved"]}
    for r in out:
        for got, _, h in r["restored"]:
            if saved.get(got) != h:
                raise AssertionError(f"{mode}: rank {r['rank']} restored "
                                     f"step {got} with other bits than "
                                     f"were saved")
    restores = sorted({(got, round(s, 3)) for r in out
                       for got, s, _ in r["restored"]})
    fail_step = lead["events"][0]["step"]
    ref, ref_norms, ref_sq = _single_rank_run(
        cfg, steps, micro, seed, dead_at=fail_step if moe else None,
        dead=tuple(range(cfg.num_experts // 2)) if moe else ())
    gaps, bad = _trajectory_gaps(steps, lead["history"], lead["param_sq"],
                                 ref, ref_norms, ref_sq)
    # launches held to the path: every step each member ran
    ran = sum(len(r["step_s"]) for r in out)
    launches = {k: sum(r["launches"][k] for r in out)
                for k in out[0]["launches"]}
    want_l = _train_launches(cfg.num_layers, micro, ran)
    for k in launches:
        if launches[k] != want_l.get(k, 0):
            raise AssertionError(f"{mode}: launches {launches}, the path "
                                 f"implies {want_l}")
    comm_tot = _comm_totals(lead)
    step_s = [t for _, t in lead["step_s"]]
    # the record first, so that a failed comparison shows its numbers
    emit({"phase": mode, "arch": cfg.name, "layers": cfg.num_layers,
          "ranks": n, "seq": ELASTIC_SEQ, "global_batch": ELASTIC_BATCH,
          "microbatches": micro,
          "events": [dict(e, hosts=list(e["hosts"])) for e in lead["events"]],
          "history_events": [h["event"] for h in lead["history"]
                             if "event" in h],
          "manifest_mesh": lead["meta"], "single_rank_losses": ref,
          "single_rank_grad_norms": ref_norms,
          "single_rank_param_sq": ref_sq, **gaps,
          "restores": restores, "restored_bit_equal": True,
          "step_s_rank0": step_s,
          "comm_rank0": comm_tot,
          "comm_s_per_step_rank0": sum(v["seconds"] for v in
                                       comm_tot.values()) / len(step_s),
          "transport": "files in the run's directory (page cache) between "
                       "gloo barriers, every rank on one card",
          "peak_gb_by_rank": [round(r["peak_gb"], 3) for r in out],
          "launches": launches, "wall_s": wall})
    if bad:
        raise AssertionError(f"{mode}: " + "; ".join(bad))
    return launches


def _rank_compress(world, seed: int, rounds: int):
    """One rank of ``compress``: granite-3-8b's layer-0 gradient leaves
    (float32, random from ``seed`` and the rank), ``compressed_psum``
    over the ranks for ``rounds`` rounds, each checked against its
    definition on the card; then the same leaves through the plain
    rank-order sum over the same transport (``comm.ordered_sum``),
    timed."""
    from repro_torch.kernels.ckpt_codec.kernel import (dequantize_blocks,
                                                       quantize_blocks)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_config
    from repro_torch.optim.compress import (compressed_psum, ef_state_init,
                                            quantize_int8)
    from repro_torch.sharding import comm

    cfg = get_config("granite-3-8b")
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    shapes = {"ln1": (d,), "wq": (d, h, hd), "wk": (d, kv, hd),
              "wv": (d, kv, hd), "wo": (h, hd, d), "w_in": (d, f),
              "w_gate": (d, f), "w_out": (f, d)}
    mesh = make_host_mesh(world.size, 1, rank=world.rank,
                          device=world.device)
    mesh.init_groups()
    group = mesh.group(("data",))
    gen = torch.Generator(device="cuda").manual_seed(seed * 131 + world.rank)
    ef = ef_state_init({k: torch.empty(s, device="cuda")
                        for k, s in shapes.items()})
    total_red = {k: torch.zeros(s, device="cuda") for k, s in shapes.items()}
    total_g = {k: torch.zeros(s, device="cuda") for k, s in shapes.items()}
    n = world.size
    q_launch, dq_launch = quantize_blocks, dequantize_blocks
    q_launch.launches = dq_launch.launches = 0
    times = []
    for _ in range(rounds):
        grads = {k: torch.randn(s, generator=gen, device="cuda") *
                 (1e-3 if k == "ln1" else 1.0) for k, s in shapes.items()}
        g_eff = {k: grads[k] + ef[k] for k in shapes}
        torch.cuda.synchronize()
        t = time.perf_counter()
        red, new_ef = compressed_psum(grads, ef, group)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        launches_q, launches_dq = q_launch.launches, dq_launch.launches
        for k in shapes:
            # the definition, by plain products on the card
            q, sc, _ = quantize_int8(g_eff[k])
            deq_own = (q.float() * sc[:, None]).reshape(-1)[
                :g_eff[k].numel()].reshape(g_eff[k].shape)
            if not torch.equal(new_ef[k], g_eff[k] - deq_own):
                raise AssertionError(f"compress: residual of {k} is not "
                                     "g_eff - deQ(Q(g_eff))")
            qs, ss = comm.all_gather(q, group), comm.all_gather(sc, group)
            acc = None
            for qr, sr in zip(qs, ss):
                dr = (qr.float() * sr[:, None]).reshape(-1)[
                    :g_eff[k].numel()].reshape(g_eff[k].shape)
                acc = dr if acc is None else acc + dr
            if not torch.equal(red[k], acc / n):
                raise AssertionError(f"compress: reduced {k} is not the "
                                     "rank-order mean of the dequantized "
                                     "payloads")
            total_red[k] += red[k]
            total_g[k] += grads[k]             # this rank's, summed below
        q_launch.launches, dq_launch.launches = launches_q, launches_dq
        ef = new_ef
    # long-run mean: sum of reduced + mean residual = sum of true means
    worst = 0.0
    for k in shapes:
        resid = comm.ordered_sum(ef[k], group) / n
        true = comm.ordered_sum(total_g[k], group) / n
        err = (total_red[k] + resid - true).abs().max().item()
        worst = max(worst, err / max(true.abs().max().item(), 1e-30))
    if worst > 1e-5:
        raise AssertionError(f"compress: long-run mean off by {worst}")
    plain = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for k in shapes:
            comm.ordered_sum(grads[k], group)
        torch.cuda.synchronize()
        plain.append(time.perf_counter() - t)
    return {"quantize": q_launch.launches, "dequantize": dq_launch.launches,
            "round_s": times, "plain_sum_s": plain,
            "long_run_rel_err": worst,
            "elements": sum(math.prod(s) for s in shapes.values())}


def phase_compress(seed: int):
    """``compress``: ``compressed_psum`` over 2 ranks on the card (see
    ``_rank_compress``); launches held to the path (per leaf and round a
    quantize, and a dequantize of the residual and of each peer's
    payload)."""
    out = _run_ranks(_rank_compress, COMPRESS_RANKS,
                     (seed, COMPRESS_ROUNDS), 600.0)
    leaves = 8
    want_q = COMPRESS_RANKS * COMPRESS_ROUNDS * leaves
    want_dq = COMPRESS_RANKS * COMPRESS_ROUNDS * leaves * (1 + COMPRESS_RANKS)
    q = sum(r["quantize"] for r in out)
    dq = sum(r["dequantize"] for r in out)
    if (q, dq) != (want_q, want_dq):
        raise AssertionError(f"compress: launches quantize {q} dequantize "
                             f"{dq}, the path implies {want_q} {want_dq}")
    r0 = out[0]
    emit({"phase": "compress", "ranks": COMPRESS_RANKS,
          "rounds": COMPRESS_ROUNDS, "elements_per_rank": r0["elements"],
          "reduced_equal_rank_order_mean": True, "residual_exact": True,
          "long_run_rel_err": max(r["long_run_rel_err"] for r in out),
          "compressed_round_ms": [t * 1e3 for t in r0["round_s"]],
          "plain_sum_ms": [t * 1e3 for t in r0["plain_sum_s"]],
          "transport": "files in the run's directory between gloo "
                       "barriers, both ranks on one card (the compressed "
                       "and the plain sum alike)",
          "launches": {"ckpt_quantize": q, "ckpt_dequantize": dq}})
    return {"ckpt_quantize": q, "ckpt_dequantize": dq}



# --------------------------------------------------------------------------
# slice 9: the chaos scenario engine
# --------------------------------------------------------------------------

# chaos-sim: every canned trace at 1000 virtual hosts (bench_chaos.py's
# arguments), and axis_loss at 1000 hosts x 2 devices over a mixtral grid
CHAOS_SIM_HOSTS = 1000
CHAOS_SIM_RATE = 20
CHAOS_SIM_SLOTS = 4
# chaos-serve: granite-3-8b as registered (40 layers, bf16); compound on 4
# replicas x 2 slots with 4 standbys (tests/test_chaos.py's set-up), then
# flash_crowd_paged on 2 paged replicas of 64 rows (tests/test_paged.py's).
# compound's streams are held to the B=1 prefill and decode; the 64-row
# decode rounds otherwise than a 1-row one in bf16 (88 of 195 streams
# differed from B=1 on an H100 80GB HBM3 at 700 W, and the B=1 replay took
# 193 s; PERF.md §6), so flash_crowd_paged's are held to a run of the same
# trace without its kill, at the same shapes, and the streams that the
# reference's test holds to B=1 (the retried ones and 8 others) to the
# port's B=1 prefill of prompt and stream, position by position: the
# stream's token within CHAOS_TF_RATIO of the B=1 logits' spread (max -
# median) of their max.  A near tie that bf16 rounding breaks the other
# way sits a few hundredths of the spread under the max; a token of
# another row, page or request sits about one spread under it.
CHAOS_TF_RATIO = 0.1
CHAOS_SERVE = {
    "compound": (dict(num_replicas=4, slots_per_replica=2, max_len=32,
                      max_pending=256, max_retries=8), 4,
                 dict(base_rate=1, prompt_len=6, max_new_tokens=6)),
    "flash_crowd_paged": (dict(num_replicas=2, slots_per_replica=4,
                               max_len=32, max_pending=512,
                               max_prefill_per_step=16, paged=True,
                               max_active=64, num_pages=200), 0,
                          dict(base_rate=1, prompt_len=8,
                               max_new_tokens=16)),
}
# chaos-train: compound through run_scenario_elastic, granite-3-8b at full
# width and 1 of 40 layers on 4 hosts x 2 ranks, (4, 2), S 1024, global
# batch 8 (ELASTIC_SEQ, ELASTIC_BATCH), 20 steps, raw saves every 2, the
# scrubber over every leaf, the telemetry plane on rank 0
CHAOS_LAYERS = 1
# chaos-serve: granite-3-8b at full width and 8 of 40 layers (its engine
# steps are host-bound, 364-421 ms at 40 layers: the cut pays for the
# other families' phases within the script's time limit)
CHAOS_SERVE_LAYERS = 8
CHAOS_STEPS = 20
CHAOS_EVERY = 2
CHAOS_HOSTS = 4
CHAOS_RANKS = 8


def _scenario_path(name: str) -> str:
    return str(ROOT / "scenarios" / f"{name}.json")


def phase_chaos_sim():
    """``chaos-sim``: ``ControlPlaneSim`` through every canned trace at
    CHAOS_SIM_HOSTS hosts (``base_rate`` CHAOS_SIM_RATE, CHAOS_SIM_SLOTS
    slots a host), and ``axis_loss`` at 1000 hosts x 2 devices over a
    mixtral-8x7b (dp, tp, ep) grid: every invariant green.  Host work on
    the card's machine: no device work."""
    from repro_torch.chaos import ControlPlaneSim, Scenario, verify
    from repro_torch.core import MeshSpec
    from repro_torch.models import get_config

    runs = [(p.stem, ControlPlaneSim(CHAOS_SIM_HOSTS,
                                     base_rate=CHAOS_SIM_RATE,
                                     slots_per_host=CHAOS_SIM_SLOTS))
            for p in sorted((ROOT / "scenarios").glob("*.json"))]
    spec = MeshSpec.from_config(get_config("mixtral-8x7b"), data=500,
                                model=2, expert=2)
    runs.append(("axis_loss", ControlPlaneSim(CHAOS_SIM_HOSTS,
                                              devices_per_host=2,
                                              mesh_spec=spec)))
    total = 0.0
    for name, sim in runs:
        rep = sim.run(Scenario.from_json(_scenario_path(name)))
        d = rep.to_dict()
        emit({"phase": "chaos-sim", "scenario": name,
              "hosts": sim.num_hosts,
              "devices_per_host": sim.devices_per_host,
              "mesh_spec": (list(spec.shape()) if sim.mesh_spec else None),
              "ticks": rep.ticks, "detected": d["detected"],
              "detection_latency_p50_s": d["detection_latency_p50"],
              "detection_latency_p99_s": d["detection_latency_p99"],
              "final_dp": d["final_dp"], "grids": sorted({
                  (m["dp"], m["mp"], m["ep"]) for m in rep.mesh_history}),
              "stale_rejected": [rep.stale_rejected, rep.stale_delivered],
              "drained": rep.drained_total,
              "completed": rep.completed_total,
              "invariants": d["invariants"],
              "wall_s": rep.wall_seconds,
              "where": "host CPU of the card's machine (no device work)"})
        verify(rep.invariants)
        total += rep.wall_seconds
    return total


def _b1_streams(cfg, params, prompts, gen, max_len):
    """Each prompt alone through the port's B=1 prefill and decode steps
    on the card (a fresh cache row of ``max_len``), greedy."""
    from repro_torch.models import init_cache
    from repro_torch.train import make_decode_step, make_prefill_step

    pre, dec = make_prefill_step(cfg), make_decode_step(cfg)
    out = {}
    with torch.no_grad():
        for rid, prompt in prompts.items():
            toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
            tok, row = pre(params, {"tokens": toks},
                           init_cache(cfg, 1, max_len, device="cuda"))
            s = [int(tok[0])]
            for _ in range(gen - 1):
                tok, row = dec(params, {"tokens": tok[:, None]}, row)
                s.append(int(tok[0]))
            out[rid] = s
    return out


def _teacher_forced(cfg, params, prompts, streams, cache_len):
    """Each stream against the port's B=1 prefill (at the engine's one
    prefill length ``cache_len``) of its prompt followed by its tokens:
    at each generated position the B=1 logits' max less the stream
    token's logit, over their spread (max - median).  Returns the
    positions, how many took the B=1 argmax, and the largest ratio."""
    import torch.nn.functional as F

    from repro_torch.models import forward, init_cache

    n = agree = 0
    worst = 0.0
    with torch.no_grad():
        for rid, stream in streams.items():
            prompt = prompts[rid]
            seq = list(prompt) + list(stream[:-1])
            toks = torch.tensor([seq], dtype=torch.long, device="cuda")
            batch = {"tokens": F.pad(toks, (0, cache_len - len(seq))),
                     "length": len(seq)}
            logits, _ = forward(cfg, params, batch, mode="prefill",
                                cache=init_cache(cfg, 1, cache_len,
                                                 device="cuda"))
            lg = logits[0, len(prompt) - 1:len(seq), :cfg.vocab_size]
            lg = lg.float()
            top = lg.max(dim=-1).values
            spread = top - lg.median(dim=-1).values
            tok = torch.tensor(stream, dtype=torch.long, device="cuda")
            gap = top - lg.gather(1, tok[:, None])[:, 0]
            n += len(stream)
            agree += int((gap == 0).sum())
            worst = max(worst, float((gap / spread).max()))
    return n, agree, worst


def _fault_free(sc):
    """``sc`` without its kills."""
    from repro_torch.chaos import Scenario

    d = sc.to_dict()
    d["events"] = [e for e in d["events"] if e["kind"] != "kill_hosts"]
    return Scenario.from_dict(d)


def _drive_serve(cfg, params, sc, eng_kw, standbys, drv_kw):
    from repro_torch.chaos import ServeScenarioDriver
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, device="cuda", fault_tolerant=True,
                      heartbeat_period=HEARTBEAT,
                      heartbeat_timeout_factor=40.0, **eng_kw)
    for _ in range(standbys):
        eng.add_standby(lambda: params)
    return eng, ServeScenarioDriver(eng, sc, **drv_kw)


def phase_chaos_serve(seed: int):
    """``chaos-serve``: ``ServeScenarioDriver`` replays ``compound`` and
    ``flash_crowd_paged`` (CHAOS_SERVE) against granite-3-8b at full
    width and CHAOS_SERVE_LAYERS of its 40 layers, one set of weights on
    the card shared by every replica and standby.  Launch counters zeroed
    just before each run and held to the path after it; every admitted request served (zero drop),
    conservation and monotonic drain at every engine step, page
    conservation on the paged pool; compound's injected kills and storm
    (``sentinel:``) failures landed and ``rejoin`` skipped, every stream
    equal to the port's B=1 prefill and decode of its prompt on the card;
    flash_crowd_paged's kill landed mid-spike, every stream equal to a
    run of the trace without the kill, and the reference test's sample
    (the retried streams and 8 others) within CHAOS_TF_RATIO of the B=1
    prefill's logits at every position (``_teacher_forced``)."""
    from repro_torch.chaos import (Scenario, check_conservation,
                                   check_monotonic_drain,
                                   check_page_conservation,
                                   check_token_identical, check_zero_drop,
                                   verify)
    from repro_torch.models import get_config, init_params

    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              num_layers=CHAOS_SERVE_LAYERS)
    L = cfg.num_layers
    params = init_params(cfg, seed=seed, device="cuda")
    counters = {k: fn for k, fn in _counters().items()
                if k in ("rmsnorm", "flash_attention", "paged_attention",
                         "selective_scan")}
    total = {k: 0 for k in counters}
    for name, (eng_kw, standbys, drv_kw) in CHAOS_SERVE.items():
        sc = Scenario.from_json(_scenario_path(name))
        eng, drv = _drive_serve(cfg, params, sc, eng_kw, standbys, drv_kw)
        for fn in counters.values():
            fn.launches = 0
        try:
            t0 = time.perf_counter()
            results = drv.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            reps = list(eng.router.replicas.values())
            res = {"prefills": sum(r.prefills for r in reps),
                   "decode_calls": sum(r.steps for r in reps)}
            launches = _serve_launches(f"chaos-serve {name}", counters, res,
                                       L)
            failures = [e for e in eng.events
                        if e["event"] == "replica_failed"]
            checks = [check_zero_drop(eng.scheduler, drv.submitted_rids),
                      check_conservation(drv.samples),
                      check_monotonic_drain(drv.drained_series)]
            if eng.paged:
                checks.append(check_page_conservation(drv.page_samples))
            rep = drv.report()
            steps = eng.engine_step
        finally:
            eng.shutdown()
        t1 = time.perf_counter()
        if name == "compound":
            oracle_kind = "b1"
            oracle = _b1_streams(cfg, params, drv.prompts,
                                 drv.max_new_tokens, eng_kw["max_len"])
        else:
            oracle_kind = "the trace without its kill"
            ref_eng, ref = _drive_serve(cfg, params, _fault_free(sc),
                                        eng_kw, standbys, drv_kw)
            try:
                oracle = ref.run()
            finally:
                ref_eng.shutdown()
            if ref.prompts != drv.prompts:
                raise AssertionError(f"chaos-serve {name}: the fault-free "
                                     f"run drew other prompts")
        oracle_s = time.perf_counter() - t1
        checks.append(check_token_identical(results, oracle))
        tf = None
        if name != "compound":
            t1 = time.perf_counter()
            retried = sorted(set(eng.scheduler.retried_rids))
            sample = retried + [r for r in drv.submitted_rids[:8]
                                if r not in retried]
            n, agree, worst = _teacher_forced(
                cfg, params, drv.prompts, {r: results[r] for r in sample},
                -(-eng_kw["max_len"] // PAGE_SIZE) * PAGE_SIZE)
            tf = {"streams": len(sample), "positions": n,
                  "b1_argmax": agree, "max_gap_over_spread": worst,
                  "limit": CHAOS_TF_RATIO,
                  "seconds": time.perf_counter() - t1}
        reasons = [f["reason"] for f in failures]
        emit({"phase": "chaos-serve", "scenario": name, "arch": cfg.name,
              "layers": L, "paged": eng.paged, "standbys": standbys,
              "engine_steps": steps, "submitted": rep["submitted"],
              "rejected": rep["rejected"], "retried": rep["retried"],
              "skipped": rep["skipped"],
              "failure_reasons": sorted({":".join(r.split(":")[:2])
                                         for r in reasons}),
              "peak_in_flight": max(x["in_flight"] for x in drv.samples),
              "wall_s": wall, "eager_ms_per_step": wall / steps * 1e3,
              "tokens": sum(len(v) for v in results.values()),
              "oracle": oracle_kind, "oracle_s": oracle_s,
              "streams_off_oracle": sorted(r for r in results
                                           if results[r] != oracle.get(r)),
              "teacher_forced_b1": tf,
              "invariants": [(c.name, bool(c.passed)) for c in checks],
              "launches": launches})
        verify(checks)
        if name == "compound":
            if (rep["skipped"] != ["rejoin"] or not rep["retried"]
                    or not any(r.startswith("injected:replica-kill")
                               for r in reasons)
                    or not any(r.startswith("sentinel:") for r in reasons)):
                raise AssertionError(f"chaos-serve compound: the trace did "
                                     f"not strike as scheduled: {rep} "
                                     f"{reasons}")
        elif not failures or not rep["retried"] or rep["rejected"]:
            raise AssertionError(f"chaos-serve {name}: {rep} {reasons}")
        elif not tf["max_gap_over_spread"] <= CHAOS_TF_RATIO:
            raise AssertionError(f"chaos-serve {name}: a stream's token "
                                 f"off the B=1 logits' max: {tf}")
        for k in total:
            total[k] += launches[k]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return total


def _rank_chaos(world, ckpt: str, seed: int):
    """One rank of ``chaos-train``: ``compound.json`` through
    ``run_scenario_elastic`` (see ``phase_chaos_train``).  Returns the
    rank's run, its launches, step and restore seconds, scrub checksum
    calls, peak memory and its steps' parameter sums of squares; on rank
    0 the telemetry log's round trip, replay and timeline."""
    import json as _json

    from repro_torch.chaos import (ControlPlaneSim, Scenario,
                                   run_scenario_elastic)
    from repro_torch.core import (Dependability, DependabilityConfig,
                                  HeartbeatEmitter)
    from repro_torch.data import ShardedPipeline
    from repro_torch.launch.mesh import host_device_map
    from repro_torch.models import get_config
    from repro_torch.obs import (Observability, Timeline, load_jsonl,
                                 to_scenario)
    from repro_torch.sharding import comm
    from repro_torch.train import init_state
    from repro_torch.train.mesh_step import (init_sharded_state,
                                             make_mesh_train_step,
                                             state_shardings)
    from repro_torch.tree import flatten_named, leaves

    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              num_layers=CHAOS_LAYERS)
    hosts = host_device_map(CHAOS_HOSTS)
    r0 = world.rank == 0
    dep = Dependability(DependabilityConfig(
        checkpoint_dir=os.path.join(ckpt, "ckpt"), policy_mode="every_n",
        every_n=CHAOS_EVERY, fsync="none", heartbeat=r0,
        heartbeat_period=HEARTBEAT, heartbeat_timeout_factor=40.0,
        signal_detection=False, scrub=True, scrub_fraction=1.0,
        monitor_hosts=CHAOS_HOSTS)).start()
    jsonl = os.path.join(ckpt, "telemetry", "events.jsonl")
    emitters = {}
    if r0:
        dep.attach_obs(Observability(jsonl_path=jsonl))
        world.publish("monaddr", _json.dumps(list(dep.monitor.addr)))
        emitters[0] = dep.emitter
    addr = tuple(_json.loads(world.fetch("monaddr")))
    my_host = next(h for h, rs in hosts.items() if world.rank in rs)
    if hosts[my_host][0] == world.rank and my_host != 0:
        emitters[my_host] = HeartbeatEmitter(my_host, addr,
                                             HEARTBEAT).start()
    like = init_state(cfg, seed=seed, device="meta")
    rec = {"step_s": [], "param_sq": [], "restore_s": [], "comm": []}

    def shardings_for(mesh):
        return state_shardings(cfg, mesh)

    def make_step(mesh):
        sh = shardings_for(mesh)
        fn = make_mesh_train_step(cfg, mesh, sh, like,
                                  warmup_steps=ELASTIC_WARMUP,
                                  total_steps=CHAOS_STEPS, donate=True)
        own = [s.replica_id() == 0 for s in leaves(sh["params"])]
        group = mesh.group(mesh.axis_names)

        def param_sq(state):
            # each shard counted once, summed over the mesh in rank order
            rec["param_sq"].append([int(state["step"]), float(
                comm.ordered_sum(_param_sq(state["params"], own), group))])

        def step(state, batch):
            if not rec["param_sq"]:
                param_sq(state)              # the initial state
            state, m = fn(state, batch)
            param_sq(state)
            return state, m
        return step

    def on_metrics(s, r):
        rec["step_s"].append([s, r["seconds"]])
        rec["comm"].append(comm.stats())
        comm.reset_stats()

    restore = dep.restore_latest

    def timed_restore(**kw):
        t = time.perf_counter()
        out = restore(**kw)
        torch.cuda.synchronize()
        rec["restore_s"].append([out[1], time.perf_counter() - t])
        return out

    dep.restore_latest = timed_restore
    leaf_names = [n for n, _ in flatten_named(like)
                  if n.startswith("params.") and "attn.wk" in n]
    data = ShardedPipeline(cfg, ELASTIC_SEQ, ELASTIC_BATCH,
                           dp_width=CHAOS_RANKS // 2)
    sc = Scenario.from_json(_scenario_path("compound"))
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    comm.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        state, info = run_scenario_elastic(
            dep, make_step,
            lambda mesh, sh: init_sharded_state(cfg, sh, seed=seed,
                                                device=world.device,
                                                world=world,
                                                ranks=mesh.ranks()),
            data, CHAOS_STEPS, world=world, scenario=sc, emitters=emitters,
            host_devices=hosts, model_axis=2, like=like,
            shardings_fn=shardings_for, leaf_names=leaf_names,
            on_metrics=on_metrics, control_timeout=600.0)
        wall = time.perf_counter() - t0
        out = {"rank": world.rank, "status": info["status"],
               "dp": info["dp"], "rollbacks": info["rollbacks"],
               "events": [dataclasses.asdict(e) for e in info["events"]],
               "history": info["history"], "report": info["report"],
               "member": state is not None, "wall_s": wall,
               "launches": {k: fn.launches for k, fn in counters.items()},
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "mismatches": list(dep.scrubber.mismatches), **rec}
        if r0:
            dep.obs.close()
            log = load_jsonl(jsonl)
            back = to_scenario(log)
            sim = ControlPlaneSim(CHAOS_HOSTS, devices_per_host=2,
                                  model_axis=2).run(back)
            out.update(scenario=back.to_dict(),
                       sim_invariants=[(r.name, bool(r.passed))
                                       for r in sim.invariants],
                       sim_detected=sorted(d["host"]
                                           for d in sim.detections),
                       timeline=Timeline.from_events(log).summary(),
                       log_events=len(log))
    finally:
        for h, em in emitters.items():
            if h != 0:
                em.stop()
        dep.stop()
    return out


def phase_chaos_train(seed: int):
    """``chaos-train``: ``compound.json`` through ``run_scenario_elastic``
    on CHAOS_RANKS ranks sharing the card (CHAOS_HOSTS hosts x 2 ranks,
    (4, 2), files over host memory), granite-3-8b at full width and
    CHAOS_LAYERS layer, S ELASTIC_SEQ, global batch ELASTIC_BATCH,
    CHAOS_STEPS steps, raw saves every CHAOS_EVERY, the scrubber over
    every leaf, the peak learning rate from step 1 and the telemetry plane
    on rank 0 writing JSONL.  Checks: every rank ``done`` with the same
    events, at least one agreed rollback, a shrink of exactly hosts 2
    and 3 at step 6 and a grow of both at 16, dp 4 at the end, flips
    landed, ``traffic_spike`` skipped, no step lost, no dead host grown,
    each surviving step's loss, gradient norm and change of the
    parameters' sum of squares within the elastic phase's limits of a
    single-rank run; the log converts back to compound.json, replays
    through ``ControlPlaneSim`` with every invariant green and detections
    {2, 3}, and its timeline's incidents all closed; launches held to the
    path (the train step's kernels for every step each rank ran, and one
    block-hash launch for each scrubber checksum pass: a record a step, a
    verify each attempt but a rank's first after each entry, a rebase a
    mesh-change restore)."""
    from repro_torch.chaos import (Scenario, check_no_dead_growth,
                                   check_no_lost_steps, verify)
    from repro_torch.models import get_config

    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              num_layers=CHAOS_LAYERS)
    ckpt = tempfile.mkdtemp(dir=_ckpt_root(), prefix="chaos_")
    t0 = time.perf_counter()
    try:
        out = _run_ranks(_rank_chaos, CHAOS_RANKS, (ckpt, seed), 1200.0)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.perf_counter() - t0
    lead = out[0]
    kinds = [(e["kind"], sorted(e["hosts"]), e["step"], e["dp"])
             for e in lead["events"]]
    rep = lead["report"]
    bad = []
    for r in out:
        if (r["status"] != "done" or r["events"] != lead["events"]
                or r["rollbacks"] != lead["rollbacks"] or not r["member"]):
            bad.append(f"rank {r['rank']}: {r['status']} {r['events']} "
                       f"rollbacks {r['rollbacks']}")
    if kinds != [("shrink", [2, 3], 6, 2), ("grow", [2, 3], 16, 4)]:
        bad.append(f"events {kinds}")
    if lead["rollbacks"] < 1 or lead["dp"] != 4:
        bad.append(f"rollbacks {lead['rollbacks']} dp {lead['dp']}")
    if not rep["sdc_injected"] or rep["skipped"] != ["traffic_spike"]:
        bad.append(f"report {rep}")
    grown = [(e["step"], list(e["hosts"])) for e in lead["events"]
             if e["kind"] == "grow"]
    invariants = [check_no_lost_steps(lead["history"], CHAOS_STEPS),
                  check_no_dead_growth(grown, {2: [(6.0, 16.0)],
                                               3: [(6.0, 16.0)]})]
    if lead["scenario"] != Scenario.from_json(
            _scenario_path("compound")).to_dict():
        bad.append("the log's scenario is not compound.json")
    if (not all(ok for _, ok in lead["sim_invariants"])
            or lead["sim_detected"] != [2, 3]):
        bad.append(f"replay {lead['sim_invariants']} "
                   f"{lead['sim_detected']}")
    tl = lead["timeline"]
    if not tl["incidents"] or tl["closed"] != tl["incidents"]:
        bad.append(f"timeline {tl}")
    ref, ref_norms, ref_sq = _single_rank_run(cfg, CHAOS_STEPS, 1, seed)
    gaps, missed = _trajectory_gaps(CHAOS_STEPS, lead["history"],
                                    lead["param_sq"], ref, ref_norms, ref_sq)
    bad += missed
    # launches held to the path
    ran = sum(len(r["step_s"]) for r in out)
    want = _train_launches(cfg.num_layers, 1, ran)
    resumes = [sum(1 for h in r["history"]
                   if str(h.get("event", "")).startswith("resume:"))
               for r in out]
    want["block_hash"] = sum(2 * len(r["step_s"]) - 1 + n
                             for r, n in zip(out, resumes))
    launches = {k: sum(r["launches"][k] for r in out)
                for k in out[0]["launches"]}
    if any(launches[k] != want.get(k, 0) for k in launches):
        bad.append(f"launches {launches}, the path implies {want}")
    step_s = [t for _, t in lead["step_s"]]
    restores = sorted({(got, round(s, 3)) for r in out
                       for got, s in r["restore_s"]})
    emit({"phase": "chaos-train", "arch": cfg.name,
          "layers": cfg.num_layers, "ranks": CHAOS_RANKS,
          "hosts": CHAOS_HOSTS, "seq": ELASTIC_SEQ,
          "global_batch": ELASTIC_BATCH, "steps": CHAOS_STEPS,
          "events": kinds, "rollbacks": lead["rollbacks"],
          "history_events": [h["event"] for h in lead["history"]
                             if "event" in h],
          "applied": [(a["phase"], a["at"], a["step"])
                      for a in rep["applied"]],
          "skipped": rep["skipped"], "sdc_injected": rep["sdc_injected"],
          "ranks_that_saw_a_flip": [r["rank"] for r in out
                                    if r["mismatches"]],
          "invariants": [(c.name, bool(c.passed)) for c in invariants],
          "single_rank_losses": ref, "single_rank_grad_norms": ref_norms,
          "single_rank_param_sq": ref_sq, **gaps,
          "step_s_rank0": step_s, "step_executions": ran,
          "restores": restores,
          "mttr_s": tl["mttr_s"], "availability": tl["availability"],
          "incidents": [tl["incidents"], tl["closed"]],
          "causes": tl["causes"], "log_events": lead["log_events"],
          "comm_rank0": _comm_totals(lead),
          "transport": "files in the run's directory (page cache) between "
                       "gloo barriers, every rank on one card",
          "peak_gb_by_rank": [round(r["peak_gb"], 3) for r in out],
          "launches": launches, "wall_s": wall})
    verify(invariants)
    if bad:
        raise AssertionError("chaos-train: " + "; ".join(bad))
    return launches


# the launch phase: the dry run over the 20 train cells (10 archs x the two
# production meshes) and the roofline over the 10 on (16, 16), each one
# subprocess on the meta device started after the build (the dry run's
# cells LAUNCH_JOBS at a time); then two rank probes on the card, rank 0
# of (16, 16) at train_4k: granite-3-8b (kv heads stored whole: 8 over tp
# 16) and falcon-mamba-7b (SSM channels over "model"), each held to its
# dry-run peak within LAUNCH_PEAK_TOL
LAUNCH_PROBES = ("granite-3-8b", "falcon-mamba-7b")
LAUNCH_PEAK_TOL = 0.10
LAUNCH_TIMEOUT = 900
LAUNCH_JOBS = 3              # the dry run's cells traced at once


def launch_tools_start():
    """The dry run and the roofline as background processes (one thread
    each), their JSONL records into ``build/``."""
    out = ROOT / "build" / "launch_tools"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = {}
    for tool, argv in (
            ("dryrun", ["--shape", "train_4k", "--both-meshes",
                        "--jobs", str(LAUNCH_JOBS)]),
            ("roofline", ["--shape", "train_4k"])):
        path = out / f"{tool}.jsonl"
        log = open(out / f"{tool}.log", "w")
        p = subprocess.Popen(
            [sys.executable, "-m", f"repro_torch.launch.{tool}", *argv,
             "--device", "meta", "--out", str(path)],
            env=env, cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT)
        log.close()
        atexit.register(p.kill)
        procs[tool] = (p, path, time.perf_counter())
    return procs


def _tool_records(procs, tool):
    p, path, t0 = procs[tool]
    try:
        p.wait(timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        p.kill()
        raise
    if not path.exists():
        log = (path.parent / f"{tool}.log").read_text()[-3000:]
        raise AssertionError(f"{tool} wrote no records (exit "
                             f"{p.returncode}):\n{log}")
    return [json.loads(l) for l in path.read_text().splitlines()]


def phase_launch(seed: int, procs):
    """``launch``: the dry run's 20 train cells all ``ok``, each one's
    peak per rank beside the card's memory; the roofline's 10 cells on
    (16, 16), their terms; then the rank probes (``LAUNCH_PROBES``): rank
    0's real step on the card from random bf16-compute shards (float32
    master weights) with the recording comm standing in for its peers,
    its measured peak held to the dry run's estimate (the estimate no more
    than ``LAUNCH_PEAK_TOL`` below it), its device time printed beside
    the roofline's per-rank compute and memory terms, its launches held
    to the path."""
    from repro_torch.launch.dryrun import rank_probe
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import input_specs
    from repro_torch.models import get_config

    card_mem = torch.cuda.get_device_properties(0).total_memory
    dry = _tool_records(procs, "dryrun")
    roof = _tool_records(procs, "roofline")
    bad = [(r["arch"], r["mesh"], r.get("error", "")[:200])
           for r in dry if r["status"] != "ok"]
    if len(dry) != 20 or bad:
        raise AssertionError(f"dry run: {len(dry)} cells, not ok: {bad}")
    for r in dry:
        peak = r["memory"]["peak_per_device_bytes"]
        emit({"phase": "launch-dryrun", "arch": r["arch"],
              "mesh": r["mesh"], "microbatches": r["microbatches"],
              "peak_gib": peak / 2**30, "card_gib": card_mem / 2**30,
              "fits_card": peak <= card_mem, "trace_s": r["lower_s"],
              "tflop_per_rank": r["cost"]["flops_per_device"] / 1e12,
              "wire_gb_per_rank": r["collectives"]["total"] / 1e9})
    bad = [r["arch"] for r in roof if r["status"] != "ok"]
    if len(roof) != 10 or bad:
        raise AssertionError(f"roofline: {len(roof)} cells, not ok: {bad}")
    for r in roof:
        emit({"phase": "launch-roofline", "arch": r["arch"],
              "mesh": r["mesh"], "compute_ms": r["compute_s"] * 1e3,
              "memory_ms": r["memory_s"] * 1e3,
              "collective_ms": r["collective_s"] * 1e3,
              "dominant": r["dominant"],
              "useful_flops_ratio": r["useful_flops_ratio"],
              "roofline_fraction": r["roofline_fraction"]})
    summary = (procs["dryrun"][1].parent / "dryrun.log").read_text()
    emit({"phase": "launch-tools",
          "dryrun_trace_s": sum(r["lower_s"] for r in dry),
          "dryrun_summary": summary.strip().splitlines()[-1],
          "cells_fitting_card": sum(
              r["memory"]["peak_per_device_bytes"] <= card_mem for r in dry)})
    launches = {}
    for arch in LAUNCH_PROBES:
        cfg = get_config(arch)
        rec = next(r for r in dry
                   if r["arch"] == arch and r["mesh"] == "16x16")
        rf = next(r for r in roof if r["arch"] == arch)
        mesh = make_production_mesh()
        mesh.rank = 0
        _, (state_g, batch), (st_sh, _) = input_specs(cfg, "train_4k", mesh)
        got = rank_probe(cfg, mesh, state_g, batch, st_sh,
                         microbatches=rec["microbatches"], seed=seed,
                         device="cuda")
        est = rec["memory"]["peak_per_device_bytes"]
        ratio = est / got["measured_peak_bytes"]
        want = _train_launches(cfg.num_layers, rec["microbatches"], 1,
                               ssm=arch == "falcon-mamba-7b")
        emit({"phase": "launch-probe", "arch": arch, "mesh": "16x16",
              "rank": 0, "microbatches": rec["microbatches"],
              "measured_peak_gib": got["measured_peak_bytes"] / 2**30,
              "estimate_gib": est / 2**30, "estimate_over_measured": ratio,
              "loss": got["loss"],
              "device_ms": got["profile"]["device_ms"],
              "wall_ms": got["profile"]["wall_ms"],
              "roofline_compute_ms": rf["compute_s"] * 1e3,
              "roofline_memory_ms": rf["memory_s"] * 1e3,
              "launches": got["launches"]})
        if ratio < 1.0 - LAUNCH_PEAK_TOL:
            raise AssertionError(f"launch-probe {arch}: the dry run's "
                                 f"{est} B is {1 - ratio:.1%} below the "
                                 f"measured {got['measured_peak_bytes']} B")
        if not math.isfinite(got["loss"]):
            raise AssertionError(f"launch-probe {arch}: loss not finite")
        if got["launches"] != want:
            raise AssertionError(f"launch-probe {arch}: launches "
                                 f"{got['launches']} != the path's {want}")
        for k, v in got["launches"].items():
            launches[k] = launches.get(k, 0) + v
        gc.collect()
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

    name, smi, bw, flops, fp32_flops = phase_card()
    phase_build()
    # the launch phase's dry run and roofline trace on the meta device,
    # on the host's cores, while the card runs the phases before it
    tools = launch_tools_start()
    cases = phase_kernels(args.seed, bw, flops, fp32_flops)
    torch.cuda.empty_cache()
    phase_tiny_slots(args.seed, phase_tiny(args.seed))
    serve = phase_serve(args.seed)
    # the serve engines hold reference cycles (the monitor's failure
    # callback and the router): collect them so that granite's weights
    # are freed before the Mamba phases
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_tiny_ssm(args.seed)
    serve_ssm = phase_serve_ssm(args.seed)
    emit({"phase": "ssm-time", "seconds": time.perf_counter() - t0})
    phase_train_tiny(args.seed)
    train = phase_train(args.seed)
    phase_train_tiny_sdc(args.seed)
    sdc = phase_train_sdc(args.seed)
    t0 = time.perf_counter()
    train_obs = phase_train_obs(args.seed)
    emit({"phase": "train-obs-time", "seconds": time.perf_counter() - t0})
    abft = phase_train_abft(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_tiny_fwi()
    fwi = phase_fwi()
    emit({"phase": "fwi-time", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    phase_train_tiny(args.seed, "falcon-mamba-7b", "train-tiny-ssm")
    train_ssm = phase_train_ssm(args.seed)
    emit({"phase": "train-ssm-time", "seconds": time.perf_counter() - t0})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_tiny_moe(args.seed)
    serve_moe = phase_serve_moe(args.seed)
    elastic = phase_elastic(args.seed, "elastic")
    elastic_moe = phase_elastic(args.seed, "elastic-moe")
    compress = phase_compress(args.seed)
    emit({"phase": "slice8-time", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    phase_chaos_sim()
    chaos_serve = phase_chaos_serve(args.seed)
    chaos_train = phase_chaos_train(args.seed)
    emit({"phase": "slice9-time", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    phase_tiny_families(args.seed)
    serve_families = phase_serve_families(args.seed)
    emit({"phase": "slice10-time", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    phase_train_tiny_families(args.seed)
    train_families = phase_train_families(args.seed)
    emit({"phase": "slice11-time", "seconds": time.perf_counter() - t0})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launch = phase_launch(args.seed, tools)
    emit({"phase": "launch-time", "seconds": time.perf_counter() - t0})

    summary = []
    for kname, case_list in cases.items():
        main_case = next(c for c in case_list if c["main"])
        source, replaces = KERNELS[kname]
        by_path = {"serve": serve["serve"].get(kname, 0),
                   "train": train.get(kname, 0), "sdc": sdc[kname],
                   "abft": abft[kname],
                   "serve_ssm": serve_ssm.get(kname, 0),
                   "fwi": fwi[kname], "train_ssm": train_ssm[kname],
                   "train_obs": train_obs[kname],
                   "serve_predrain": serve["serve_predrain"].get(kname, 0),
                   "serve_slots": serve["serve_slots"].get(kname, 0),
                   "serve_standby": serve["serve_standby"].get(kname, 0),
                   "serve_moe": serve_moe.get(kname, 0),
                   "elastic": elastic.get(kname, 0),
                   "elastic_moe": elastic_moe.get(kname, 0),
                   "compress": compress.get(kname, 0),
                   "chaos_serve": chaos_serve.get(kname, 0),
                   "chaos_train": chaos_train.get(kname, 0),
                   "serve_families": serve_families.get(kname, 0),
                   "train_families": train_families.get(kname, 0),
                   "launch": launch.get(kname, 0)}
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
