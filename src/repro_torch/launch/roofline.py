"""Roofline of every train cell on an H100 model (the reference's
``launch/roofline.py``).

Hardware model (``HW``): one H100 SXM5 80GB at 700 W, from NVIDIA's data
sheets: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s
each way inside an 8-GPU node, and one 400 Gb/s NDR port a GPU (50 GB/s,
as in DGX H100) across nodes.  ``PARTS`` keys the three H100 parts by
the name the card reports (PCIe / NVL / SXM; ``part_of``): the peaks
``chip_smoke.py``'s kernel bounds read.

Method (the reference's probe-corrected accounting): two probes a cell,
rank 0 of the mesh traced on the meta device through its gradient
function (``train/mesh_step.py``'s ``begin``, one microbatch and
``reduce``: the FSDP gathers, forward and backward with recomputation,
the gradient sums; ``dryrun.trace_rank_step``) at one microbatch's
rows, through the plain attention (``impl="einsum"``: exact FLOPs, and
the S x S scores counted as the naive-attention baseline, as the
reference's einsum probes count them):

    probe(L=0)     embed + head + loss (+ bwd)        [no layers]
    probe(L=P)     one pattern block of layers

and ``total = L0 + (L/P)(LP - L0)``, taken apart by phase: the
microbatch's forward and backward times the microbatches, the once-a-
step gathers and gradient sums once (the reference's probe prices them
every microbatch; the port's step gathers once a step).  A step adds the
reference's closed-form AdamW and clip term: 25 FLOPs and 36 bytes per
local parameter, no collective.

What is counted, per rank: FLOPs, ``torch.utils.flop_counter``'s
products plus the kernels' operation counts (``kernels/meta.py``);
bytes, each dispatched op's inputs and outputs, unfused (XLA's per-op
"bytes accessed"), views excepted (``dryrun.StepTrace``); wire bytes,
each collective's output through the reference's formulas
(``comm.wire_bytes``).  A collective whose group spans nodes (8 ranks a
node, in rank order) takes the node link, else NVLink.

    PYTHONPATH=src python -m repro_torch.launch.roofline --shape train_4k \\
        --device meta [--arch ARCH] [--out r.jsonl]

``--device cuda`` records the card's name and ``nvidia-smi`` power
limit beside the model's numbers (the model is the SXM5's either way).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.launch.shapes import (META, SHAPES, cell_applicable,
                                       input_specs, shard_shapes)
from repro_torch.models import get_config
from repro_torch.models.base import ModelConfig

# NVIDIA's data sheets, dense rates: bytes/s of HBM, bf16 FLOP/s on the
# tensor cores, float32 FLOP/s on the CUDA cores, bytes of HBM
PARTS: Dict[str, Dict[str, float]] = {
    "H100 PCIe": {"hbm_bw": 2.0e12, "peak_flops": 756e12,
                  "fp32_flops": 51e12, "hbm_bytes": 80e9},
    "H100 NVL": {"hbm_bw": 3.9e12, "peak_flops": 835e12,
                 "fp32_flops": 60e12, "hbm_bytes": 94e9},
    "H100 SXM": {"hbm_bw": 3.35e12, "peak_flops": 989e12,
                 "fp32_flops": 67e12, "hbm_bytes": 80e9},
}
HW: Dict[str, float] = {
    **PARTS["H100 SXM"],
    "nvlink_bw": 450e9,       # bytes/s each way, NVLink 4, inside a node
    "node_bw": 50e9,          # bytes/s, one 400 Gb/s NDR port a GPU
    "gpus_per_node": 8,
}
ADAMW_FLOPS, ADAMW_BYTES = 25.0, 36.0       # per local parameter


def part_of(name: str) -> str:
    """The ``PARTS`` key of a card's name (SXM when none matches)."""
    for key in PARTS:
        if key.split()[1] in name:
            return key
    return "H100 SXM"


@dataclasses.dataclass
class ProbeCost:
    flops: float
    bytes: float
    coll: Dict[str, float]      # wire bytes by class and link

    def __sub__(self, o):
        return ProbeCost(self.flops - o.flops, self.bytes - o.bytes,
                         {k: self.coll.get(k, 0) - o.coll.get(k, 0)
                          for k in self.coll})

    def scaled(self, f):
        return ProbeCost(self.flops * f, self.bytes * f,
                         {k: v * f for k, v in self.coll.items()})

    def __add__(self, o):
        keys = set(self.coll) | set(o.coll)
        return ProbeCost(self.flops + o.flops, self.bytes + o.bytes,
                         {k: self.coll.get(k, 0) + o.coll.get(k, 0)
                          for k in keys})


def spans_nodes(ranks: Sequence[int]) -> bool:
    per = int(HW["gpus_per_node"])
    return len({r // per for r in ranks}) > 1


def _cost(phases) -> ProbeCost:
    from repro_torch.sharding import comm

    flops = sum(p.flops for p in phases)
    nbytes = sum(p.bytes for p in phases)
    coll: Dict[str, float] = {}
    for p in phases:
        for cls, g, out, ranks in p.coll:
            link = "node" if spans_nodes(ranks) else "nvlink"
            w = comm.wire_bytes(cls, g, out)
            coll[cls] = coll.get(cls, 0.0) + w
            coll[f"link:{link}"] = coll.get(f"link:{link}", 0.0) + w
    return ProbeCost(flops, nbytes, coll)


def _probe(cfg: ModelConfig, shape_name: str, multi_pod: bool, layers: int,
           microbatches: int):
    """(once a step, per microbatch) costs of rank 0's gradient function
    at ``layers`` layers and one microbatch's rows."""
    from repro_torch.launch.dryrun import trace_rank_step
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train.mesh_step import shard_tree

    pcfg = dataclasses.replace(cfg, num_layers=layers)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh.rank, mesh.device = 0, META
    seq, batch, _ = SHAPES[shape_name]
    _, (state_g, bt), (st_sh, _) = input_specs(pcfg, shape_name, mesh)
    rows = batch // microbatches
    bt = {k: (x[:, :rows] if k == "positions" else x[:rows])
          for k, x in bt.items()}
    state = shard_tree(state_g, st_sh)
    phases, _, _ = trace_rank_step(pcfg, mesh, state, bt, st_sh, state_g,
                                   microbatches=1, rank=0, impl="einsum",
                                   update=False)
    return (_cost([phases["begin"], phases["reduce"]]),
            _cost([phases["microbatch"]]))


def _local_params(cfg: ModelConfig, multi_pod: bool) -> int:
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import params_sds

    mesh = make_production_mesh(multi_pod=multi_pod)
    params, sh = params_sds(cfg, mesh, serve_dtype=False)
    total = 0
    for shape in shard_shapes(params, sh, 0).values():
        n = 1
        for d in shape:
            n *= d
        total += n
    return total


def card_info() -> Optional[Dict[str, str]]:
    """The card's name and ``nvidia-smi`` power limit, None without a
    card."""
    if not torch.cuda.is_available():
        return None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in smi.split(",", 1))
    return {"name": name, "power_limit": power}


def model_flops(cfg: ModelConfig, shape_name: str) -> int:
    """MODEL_FLOPS: 6 N D for a train cell, 2 N D for a serve cell (N
    the active parameters, D the cell's tokens)."""
    seq, batch, mode = SHAPES[shape_name]
    tokens = batch * (1 if mode == "decode" else seq)
    return (6 if mode == "train" else 2) * cfg.num_active_params() * tokens


def roofline_cell(arch: str, shape_name: str, *, microbatches: int = 1,
                  multi_pod: bool = False,
                  cfg_overrides: Optional[dict] = None,
                  flash_mem: bool = False, card=None) -> Dict:
    """One train cell's terms on the H100 model (module docstring)."""
    if flash_mem:
        raise NotImplementedError(
            "flash_mem: the port has no blocked-attention twin of the "
            "reference's blocked probes (a lead of ROADMAP item 13b)")
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    base = {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16"}
    ok, reason = cell_applicable(cfg, shape_name)
    if not ok:
        return {**base, "status": "skip", "reason": reason}
    seq, batch, mode = SHAPES[shape_name]
    if mode != "train":
        from repro_torch.launch.dryrun import SERVE_FAIL

        return {**base, "status": "fail", "error": SERVE_FAIL}
    chips = 512 if multi_pod else 256
    P = len(cfg.pattern)
    L = cfg.num_layers
    mb = microbatches
    once0, mb0 = _probe(cfg, shape_name, multi_pod, 0, mb)
    onceP, mbP = _probe(cfg, shape_name, multi_pod, P, mb)
    once = once0 + (onceP - once0).scaled(L / P)
    per_mb = mb0 + (mbP - mb0).scaled(L / P)
    n_local = _local_params(cfg, multi_pod)
    total = once + per_mb.scaled(mb) + ProbeCost(
        ADAMW_FLOPS * n_local, ADAMW_BYTES * n_local, {})

    compute_s = total.flops / HW["peak_flops"]
    memory_s = total.bytes / HW["hbm_bw"]
    coll_s = (total.coll.get("link:node", 0.0) / HW["node_bw"]
              + total.coll.get("link:nvlink", 0.0) / HW["nvlink_bw"])
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", coll_s), key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape_name)
    ratio = mf / max(total.flops * chips, 1.0)
    step_s = max(compute_s, memory_s, coll_s)
    ideal_s = mf / (chips * HW["peak_flops"])
    coll_bytes = sum(v for k, v in total.coll.items()
                     if k.startswith("link:"))
    rec = {
        **base, "mode": mode, "status": "ok", "microbatches": mb,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": coll_s, "dominant": dominant,
        "flops_per_dev": total.flops, "bytes_per_dev": total.bytes,
        "coll_bytes_per_dev": coll_bytes,
        "coll_breakdown": {k: v for k, v in total.coll.items()
                           if not k.startswith("link:") and v > 0},
        "coll_by_link": {k[5:]: v for k, v in total.coll.items()
                         if k.startswith("link:")},
        "model_flops": mf,
        "useful_flops_ratio": ratio,
        "roofline_fraction": ideal_s / step_s if step_s else 0.0,
        "local_params": n_local,
        "hardware": {"model": "H100 SXM5 80GB, 700 W (data sheet)",
                     **{k: HW[k] for k in ("peak_flops", "hbm_bw",
                                           "nvlink_bw", "node_bw")}},
    }
    if card is not None:
        rec["card"] = card
    return rec


def main(argv=None) -> int:
    from repro_torch.configs import ALL_ARCHS
    from repro_torch.launch.dryrun import microbatches_for

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "meta"],
                    help="cuda: record the card's name and power limit "
                         "(raises without a card)")
    args = ap.parse_args(argv)
    card = None
    if args.device == "cuda":
        card = card_info()
        if card is None:
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(pass --device meta)")
    archs = [args.arch] if args.arch else list(ALL_ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    records: List[Dict] = []
    for arch in archs:
        for shape in shapes:
            seq, batch, mode = SHAPES[shape]
            mb = microbatches_for(arch, mode, batch, 16)
            try:
                rec = roofline_cell(arch, shape, microbatches=mb, card=card)
            except Exception as e:
                rec = {"arch": arch, "shape": shape, "status": "fail",
                       "error": str(e)[:500]}
            records.append(rec)
            if rec["status"] == "ok":
                print(f"[roofline] {arch} x {shape}: "
                      f"compute={rec['compute_s']*1e3:.2f}ms "
                      f"memory={rec['memory_s']*1e3:.2f}ms "
                      f"coll={rec['collective_s']*1e3:.2f}ms "
                      f"dominant={rec['dominant']} "
                      f"useful={rec['useful_flops_ratio']:.2f} "
                      f"roofline={rec['roofline_fraction']*100:.1f}%",
                      flush=True)
            else:
                print(f"[roofline] {arch} x {shape}: {rec['status']} "
                      f"{rec.get('reason', rec.get('error', ''))[:120]}",
                      flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
