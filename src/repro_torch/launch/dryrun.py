"""Dry run: one rank's train step of every (architecture x input-shape)
cell on the production meshes, traced on the meta device (the
reference's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
        --shape train_4k [--multi-pod] [--both-meshes] [--all] \\
        [--out out.jsonl] [--device cuda|meta] [--jobs N]

For each train cell this proves the distribution config is coherent (the
rank's shards, the step's collectives over them, memory that fits) by
tracing rank 0 of the mesh: its shards (``launch/shapes.py``; rank 0
holds the largest, as shards of ``ceil(n / w)`` put the short ones
last) as meta tensors, ``train/mesh_step.py``'s step under
``comm.recording`` (collectives stand in for the peers and are counted),
the kernels as their meta ops (``kernels/meta.py``).  It records the
reference's keys:

- ``memory``: ``argument_bytes`` (the rank's state and batch shards,
  exact), ``temp_bytes`` (the most bytes of storage allocated inside the
  step and alive at once, from a dispatch mode that tracks every
  storage), ``output_bytes`` and ``alias_bytes`` (the donated state comes
  back in place), ``peak_per_device_bytes`` = arguments + temporaries;
- ``cost``: ``flops_per_device`` (``torch.utils.flop_counter``'s
  formulas for the products, ``FlopCounterMode``'s, and the kernels'
  operation counts) and ``bytes_per_device``
  (each dispatched op's inputs and outputs, views excepted);

and adds ``collectives`` (wire bytes by class, ``comm.wire_bytes``),
``fits`` (the peak against the card's memory: the device's own with
``--device cuda``, the H100 model's 80 GB with ``--device meta``) and
``composition``.  A step of M microbatches is traced as ``begin`` (the
weights' gathers), one microbatch's forward and backward at full depth,
``reduce`` and ``update`` (``MeshTrainStep``); its totals are begin + M
x the microbatch + reduce + update, and its peak the largest of the
phases' with the accumulated gradients held through a second
microbatch (M >= 2).  ``lower_s`` is the trace's seconds; ``compile_s``
is 0 (nothing compiles: the kernels are built ahead).

Serve cells (prefill_32k, decode_32k, long_500k) are ``fail``: the port
has no mesh serving step yet (ROADMAP item 13b).  A cell the reference
skips is ``skip`` with its reason.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

import repro_torch.kernels.meta  # noqa: F401  (the kernels' FLOP formulas)
from repro_torch.configs import ALL_ARCHS
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import (META, SHAPES, cell_applicable,
                                       input_specs, shard_bytes)
from repro_torch.models import get_config
from repro_torch.sharding import comm
from repro_torch.train.mesh_step import MeshTrainStep, shard_tree
from repro_torch.tree import leaves

# Gradient-accumulation defaults per arch for train_4k, the reference's
# cells: live activations of one microbatch have to fit the H100's 80 GB
# beside the rank's state (``fits`` says whether they do).
DEFAULT_MICROBATCHES = {"qwen1.5-110b": 16, "gemma2-27b": 8,
                        "recurrentgemma-2b": 8}
FALLBACK_MICROBATCHES = 4
SERVE_FAIL = "no mesh serving step in the port yet (ROADMAP item 13b)"


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def microbatches_for(arch: str, mode: str, batch: int, dp: int,
                     microbatches: Optional[int] = None) -> int:
    """The reference's count: its table, then halved until each
    microbatch's rows divide over DP."""
    if microbatches is None:
        microbatches = (DEFAULT_MICROBATCHES.get(arch, FALLBACK_MICROBATCHES)
                        if mode == "train" else 1)
    if mode == "train":
        while microbatches > 1 and (batch // microbatches) % dp:
            microbatches //= 2
    return microbatches


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(items) -> List[torch.Tensor]:
    """The tensors among an op's arguments or outputs (a list or tuple
    of tensors, as ``cat`` takes, included)."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of ``tree``'s tensors."""
    seen = {}
    for x in leaves(tree):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


class StepTrace(TorchDispatchMode):
    """Every storage an op allocates, alive until freed (``live``, its
    ``peak``), the bytes each op reads and writes (``bytes``: its tensor
    inputs and outputs; a view moves none) and its FLOPs (``flops``:
    ``FlopCounterMode``'s formulas, ``flop_counter.flop_registry``, the
    kernels' among them).  Storages that exist when the trace starts
    (``adopt``) are not counted."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.bytes = 0.0
        self.flops = 0
        self._formulas = dict(flop_registry)
        self._sizes: Dict[int, int] = {}
        self._known: set = set()

    def adopt(self, tree) -> None:
        for x in leaves(tree):
            if isinstance(x, torch.Tensor):
                self._known.add(id(x.untyped_storage()))

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes or key in self._known:
            return
        self._sizes[key] = n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def window(self) -> None:
        """Start a new peak from what is alive now."""
        self.peak = self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors((out,))
        in_st = {id(t.untyped_storage()) for t in ins}
        view = (not func._schema.is_mutable and outs
                and all(id(t.untyped_storage()) in in_st for t in outs))
        if not view:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


class _Phase:
    """Counters read around one phase of a traced step."""

    def __init__(self, trace: StepTrace, rec: comm.Recorder):
        self.trace, self.rec = trace, rec

    def __enter__(self):
        self.trace.window()
        self.f0 = self.trace.flops
        self.b0 = self.trace.bytes
        self.c0 = len(self.rec.records)
        return self

    def __exit__(self, *exc):
        self.flops = self.trace.flops - self.f0
        self.bytes = self.trace.bytes - self.b0
        self.peak = self.trace.peak
        self.coll = self.rec.records[self.c0:]
        return False


def device_memory(device: str):
    """(name, total bytes) of the card ``device`` names, or the H100
    model's (``roofline.HW``) for ``"meta"``; raises for ``"cuda"``
    without a card."""
    from repro_torch.launch.roofline import HW

    if device == "meta":
        return "H100 model", HW["hbm_bytes"]
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device meta for the H100 model)")
    props = torch.cuda.get_device_properties(0)
    return props.name, props.total_memory


def trace_rank_step(cfg, mesh, state, batch, shardings, like, *,
                    microbatches: int, rank: int, impl: Optional[str] = None,
                    update: bool = True):
    """One rank's step over ``state`` (its shards) and the global
    ``batch``, phase by phase under ``comm.recording``: a dict of the
    phases' counters (``begin``, ``microbatch``, ``reduce``, ``update``)
    and the accumulated gradients' bytes.  ``update=False`` stops after
    ``reduce`` (the roofline's gradient probe)."""
    mesh.rank = rank
    tr = StepTrace()
    tr.adopt((state, batch))
    with comm.recording(mesh) as rec, tr:
        step = MeshTrainStep(cfg, mesh, shardings, like, peak_lr=3e-4,
                             warmup_steps=100, total_steps=10_000,
                             weight_decay=0.1, clip_norm=1.0,
                             microbatches=microbatches, donate=True,
                             impl=impl)
        phases = {}
        with _Phase(tr, rec) as ph:
            run = step.begin(state, batch)
        phases["begin"] = ph
        with _Phase(tr, rec) as ph:
            step.microbatch(run, 0)
        phases["microbatch"] = ph
        acc_bytes = storage_bytes(run.acc)
        with _Phase(tr, rec) as ph:
            grads = step.reduce(run)
        phases["reduce"] = ph
        out = None
        if update:
            with _Phase(tr, rec) as ph:
                out = step.update(state, run, grads)
            phases["update"] = ph
        del grads, run
    return phases, acc_bytes, out


def trace_cell(cfg, mesh, state_g, batch, st_sh, b_sh, *,
               microbatches: int, rank: int = 0) -> Dict:
    """``memory``, ``cost``, ``collectives`` and ``lower_s`` of rank
    ``rank``'s step over the global state ``state_g`` (meta) and the
    global ``batch`` on ``mesh`` (module docstring)."""
    mb = microbatches
    last = int(mesh.devices.reshape(-1)[-1])
    args = {r: shard_bytes(state_g, st_sh, r) + shard_bytes(batch, b_sh, r)
            for r in (rank, last)}
    mesh.rank, mesh.device = rank, META
    t0 = time.perf_counter()
    state = shard_tree(state_g, st_sh)
    p, acc, out = trace_rank_step(cfg, mesh, state, batch, st_sh, state_g,
                                  microbatches=mb, rank=rank)
    t_trace = time.perf_counter() - t0
    temp = max(p["begin"].peak,
               p["microbatch"].peak + (acc if mb > 1 else 0),
               p["reduce"].peak, p["update"].peak)
    once = ("begin", "reduce", "update")
    coll = [r for k in once for r in p[k].coll] + p["microbatch"].coll * mb
    return {
        "lower_s": round(t_trace, 2),
        "memory": {
            "argument_bytes": args[rank],
            "output_bytes": storage_bytes(out),
            "temp_bytes": temp,
            "alias_bytes": storage_bytes(out[0]),  # donated state
            "peak_per_device_bytes": args[rank] + temp,
            "last_rank_argument_bytes": args[last],
        },
        "cost": {
            "flops_per_device": float(sum(p[k].flops for k in once)
                                      + mb * p["microbatch"].flops),
            "bytes_per_device": float(sum(p[k].bytes for k in once)
                                      + mb * p["microbatch"].bytes)},
        "collectives": comm.wire_totals(coll),
        "composition": (f"begin + {mb} x one microbatch (forward and "
                        "backward at full depth) + reduce + update; peak "
                        "with the accumulated gradients"
                        + (" through a second microbatch" if mb > 1
                           else "")),
    }


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               microbatches: Optional[int] = None,
               device: str = "meta") -> Dict:
    """The record of one train cell, traced at rank 0 (module
    docstring)."""
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh.rank = 0
    mode, (state_g, batch), (st_sh, b_sh) = input_specs(cfg, shape_name,
                                                       mesh)
    seq, B, _ = SHAPES[shape_name]
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    mb = microbatches_for(arch, mode, B, dp, microbatches)
    card, total_mem = device_memory(device)
    rec = trace_cell(cfg, mesh, state_g, batch, st_sh, b_sh,
                     microbatches=mb)
    return {
        "arch": arch, "shape": shape_name, "mode": mode,
        "mesh": mesh_name(multi_pod), "seq": seq, "batch": B,
        "lower_s": rec.pop("lower_s"), "compile_s": 0.0,
        "microbatches": mb, "rank": 0, **rec,
        "fits": rec["memory"]["peak_per_device_bytes"] <= total_mem,
        "device": {"name": card, "memory_bytes": total_mem},
    }


def _fill(x: torch.Tensor, name: str, gen, device) -> torch.Tensor:
    """A leaf of a random state on ``device``: parameters N(0, 0.02)
    (norms 1), moments 0, scalars and the key as they are."""
    if name.startswith("opt.") and x.dim() > 0:
        return torch.zeros(x.shape, dtype=x.dtype, device=device)
    if not name.startswith("params."):
        return torch.zeros(x.shape, dtype=x.dtype, device=device)
    if x.dim() == 1 or name.endswith(("ln", "ln1", "ln2", "ln1_post",
                                      "ln2_post", "final_norm")):
        return torch.ones(x.shape, dtype=x.dtype, device=device)
    return (torch.randn(x.shape, generator=gen, device=device,
                        dtype=torch.float32) * 0.02).to(x.dtype)


def random_batch(cfg, batch, *, seed: int, device) -> Dict[str, torch.Tensor]:
    """A global batch shaped like ``batch`` (meta) with random tokens or
    embeddings, random targets and text positions."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for k, x in batch.items():
        if k == "embeddings":
            out[k] = (torch.randn(x.shape, generator=gen, device=device)
                      * 0.02).to(x.dtype)
        elif k == "positions":
            S = x.shape[-1]
            out[k] = torch.arange(S, dtype=x.dtype, device=device).expand(
                x.shape).contiguous()
        else:
            out[k] = torch.randint(0, cfg.vocab_size, x.shape,
                                   generator=gen, device=device,
                                   dtype=x.dtype)
    return out


def rank_probe(cfg, mesh, state_g, batch, st_sh, *, microbatches: int,
               seed: int, device, rank: int = 0, profile: bool = True
               ) -> Dict:
    """One step of rank ``rank`` on the card: its shards of a random
    state (``seed``), the global batch, ``comm.recording`` in place of
    the peers (the dry run's trace, run).  Returns the step's
    ``measured_peak_bytes`` (``torch.cuda.max_memory_allocated`` over the
    step, the rank's state and batch included, less what the caller held
    before), its ``loss``, its launch
    counts by kernel, and with ``profile`` its device time
    (``launch.profile_steps.profile_step``: one more step)."""
    from repro_torch.launch.profile_steps import profile_step
    from repro_torch.tree import flatten_named, unflatten

    dev = torch.device(device)
    mesh.rank, mesh.device = rank, META
    shards = shard_tree(state_g, st_sh)             # shapes only
    mesh.device = dev
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    torch.cuda.empty_cache()
    # empty_cache also frees cuBLAS's workspace: one product takes it back
    # before the baseline (a process holds it once, not a step)
    torch.ones(1, 1, device=dev) @ torch.ones(1, 1, device=dev)
    base = torch.cuda.memory_allocated()       # the caller's own tensors
    state = unflatten(state_g, [
        _fill(x, name, gen, dev) if isinstance(x, torch.Tensor) else x
        for name, x in flatten_named(shards)])
    data = random_batch(cfg, batch, seed=seed, device=dev)
    counters = kernel_counters()
    with comm.recording(mesh):
        step = MeshTrainStep(cfg, mesh, st_sh, state_g, peak_lr=3e-4,
                             warmup_steps=100, total_steps=10_000,
                             weight_decay=0.1, clip_norm=1.0,
                             microbatches=microbatches, donate=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        state, metrics = step(state, data)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        out = {"measured_peak_bytes":
               torch.cuda.max_memory_allocated() - base,
               "loss": loss,
               "launches": {k: fn.launches for k, fn in counters.items()}}
        if profile:
            holder = [state]

            def one():
                holder[0], _ = step(holder[0], data)

            out["profile"] = profile_step(one, calls=1, warm=True,
                                          host=False)
    del state, data
    torch.cuda.empty_cache()
    return out


def kernel_counters() -> Dict[str, object]:
    """The wrappers of the kernels a train step launches, by name (each
    counts its launches in ``.launches``)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bshd, flash_attention_bshd_bwd)
    from repro_torch.kernels.rmsnorm.kernel import (rms_norm_2d,
                                                    rms_norm_2d_bwd)
    from repro_torch.kernels.selective_scan.kernel import (
        selective_scan_bwd_kernel, selective_scan_kernel)

    return {"rmsnorm": rms_norm_2d, "rmsnorm_bwd": rms_norm_2d_bwd,
            "flash_attention": flash_attention_bshd,
            "flash_attention_bwd": flash_attention_bshd_bwd,
            "selective_scan": selective_scan_kernel,
            "selective_scan_bwd": selective_scan_bwd_kernel}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             device: str = "meta", verbose: bool = True) -> Dict:
    cfg = get_config(arch)
    base = {"arch": arch, "shape": shape_name,
            "mesh": mesh_name(multi_pod)}
    ok, reason = cell_applicable(cfg, shape_name)
    if not ok:
        if verbose:
            print(f"[skip] {arch} x {shape_name}: {reason}", flush=True)
        return {**base, "status": "skip", "reason": reason}
    if SHAPES[shape_name][2] != "train":
        if verbose:
            print(f"[FAIL] {arch} x {shape_name}: {SERVE_FAIL}", flush=True)
        return {**base, "status": "fail", "error": SERVE_FAIL}
    try:
        rec = {**lower_cell(arch, shape_name, multi_pod=multi_pod,
                            device=device), "status": "ok"}
    except Exception as e:  # a failure here is a bug in the system
        if verbose:
            print(f"[FAIL] {arch} x {shape_name}: {e}", flush=True)
            traceback.print_exc()
        return {**base, "status": "fail", "error": str(e)[:2000]}
    if verbose:
        gb = rec["memory"]["peak_per_device_bytes"] / 2**30
        print(f"[ok]   {arch} x {shape_name} ({rec['mesh']}): "
              f"trace={rec['lower_s']}s peak/dev={gb:.2f}GiB "
              f"fits={rec['fits']} "
              f"flops/dev={rec['cost']['flops_per_device']:.3e} "
              f"wire/dev={rec['collectives']['total']:.3e}B", flush=True)
    return rec


def _run_cells(cells, device: str, jobs: int):
    """The cells' records in order: traced here, or ``jobs`` at once in
    spawned processes of one thread each (the slowest cell,
    recurrentgemma-2b's ~10^5 RG-LRU scan ops, beside the others)."""
    if jobs <= 1:
        for cell in cells:
            yield run_cell(*cell, device=device)
        return
    import concurrent.futures
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            jobs, mp_context=ctx, initializer=torch.set_num_threads,
            initargs=(1,)) as pool:
        futures = [pool.submit(run_cell, *cell, device=device)
                   for cell in cells]
        for fut in futures:
            yield fut.result()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ALL_ARCHS) + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "meta"],
                    help="the memory ``fits`` compares with: the card's "
                         "(cuda) or the H100 model's (meta)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    args = ap.parse_args(argv)
    device_memory(args.device)          # no card under cuda: raise now

    archs = list(ALL_ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    records = []
    failed = 0
    t0 = time.perf_counter()
    for rec in _run_cells(cells, args.device, args.jobs):
        records.append(rec)
        failed += rec["status"] == "fail"
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    print(f"\n{len(records)} cells: "
          f"{sum(r['status'] == 'ok' for r in records)} ok, "
          f"{sum(r['status'] == 'skip' for r in records)} skip, "
          f"{failed} fail in {time.perf_counter() - t0:.1f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
