"""The port's roofline (``repro_torch.launch.roofline``) on the CPU.

- The wire formula (``comm.wire_bytes``) equals the reference's
  ``parse_collectives`` on synthetic HLO lines, one a class, at several
  group sizes (the reference's function is pure text).
- ``model_flops`` equals 6 x the reference config's
  ``num_active_params`` x the cell's tokens for all ten archs.
- The counted FLOPs of a tiny dense probe (rank 0 of a (1, 1) mesh,
  the plain attention) equal a closed form of its products.
- ``flash_mem=True`` raises naming ROADMAP; serve cells fail and the
  reference's inapplicable cells skip; the H100 model's numbers; no
  TPU v5e constant in the port.
- One full-width cell (hubert-xlarge train_4k, ~5 s) runs through the
  CLI with ``--device meta`` and carries the reference's keys.
"""
import dataclasses
import json
import pathlib

import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.launch.roofline import parse_collectives
from repro.models import get_config as jax_get_config
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import trace_rank_step
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.launch.shapes import META, batch_sds, state_sds
from repro_torch.models import get_config
from repro_torch.sharding import comm
from repro_torch.train.mesh_step import shard_tree

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the reference's record keys (repro/launch/roofline.py: roofline_cell)
REF_KEYS = {"arch", "shape", "mode", "status", "mesh", "microbatches",
            "compute_s", "memory_s", "collective_s", "dominant",
            "flops_per_dev", "bytes_per_dev", "coll_bytes_per_dev",
            "coll_breakdown", "model_flops", "useful_flops_ratio",
            "roofline_fraction"}
_OPS = {"all-reduce": "all-reduce", "all-gather": "all-gather",
        "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
        "collective-permute": "collective-permute"}


@pytest.mark.parametrize("cls", list(_OPS))
@pytest.mark.parametrize("g", [2, 4, 16])
def test_wire_formula_equals_the_references_parser(cls, g):
    dims, dtype, es = (8, 1024), "bf16", 2
    out = dims[0] * dims[1] * es
    line = (f"  %c.1 = {dtype}[{dims[0]},{dims[1]}]{{1,0}} {_OPS[cls]}"
            f"(%p.0), replica_groups=[{512 // g},{g}]<=[512]")
    got = parse_collectives(line)
    assert got[cls] == pytest.approx(comm.wire_bytes(cls, g, out),
                                     rel=1e-15)
    line2 = (f"  %c.2 = f32[{dims[0]}]{{0}} {_OPS[cls]}(%p.1), "
             f"replica_groups={{{{{','.join(map(str, range(g)))}}}}}")
    assert parse_collectives(line2)[cls] == pytest.approx(
        comm.wire_bytes(cls, g, dims[0] * 4), rel=1e-15)


def test_model_flops_equal_the_references():
    for arch in ALL_ARCHS:
        j = jax_get_config(arch)
        for shape, (seq, batch, mode) in roofline.SHAPES.items():
            tokens = batch * (1 if mode == "decode" else seq)
            coef = 6 if mode == "train" else 2
            assert roofline.model_flops(get_config(arch), shape) == \
                coef * j.num_active_params() * tokens, (arch, shape)


def test_counted_flops_of_a_tiny_dense_probe_are_the_closed_form():
    """Tiny granite, one microbatch of B x S on one rank through the
    plain attention: per layer the q/k/v/o and MLP products and the two
    attention einsums, forward, recomputed (all but the MLP's last
    product: the recomputation stops at the last tensor the backward
    saved) and twice in the backward; the tied logits forward and twice
    back; no other op counts."""
    cfg = dataclasses.replace(get_config("granite-3-8b", tiny=True),
                              dtype=torch.float32)
    B, S = 2, 32
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    mesh.rank, mesh.device = 0, META
    st, st_sh = state_sds(cfg, mesh)
    batch, _ = batch_sds(cfg, S, B, mesh, "train")
    phases, _, _ = trace_rank_step(cfg, mesh, shard_tree(st, st_sh), batch,
                                   st_sh, st, microbatches=1, rank=0,
                                   impl="einsum", update=False)
    T, D, F, V = B * S, cfg.d_model, cfg.d_ff, cfg.padded_vocab
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    proj = 2 * T * D * hd * (2 * H + 2 * K) + 2 * T * 3 * D * F
    attn = 2 * (2 * B * H * S * S * hd)
    w_out = 2 * T * F * D
    want = cfg.num_layers * (4 * (proj + attn) - w_out) + 6 * T * D * V
    assert phases["microbatch"].flops == want
    assert phases["begin"].flops == phases["reduce"].flops == 0


def test_refusals_serve_and_skip_cells():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        roofline.roofline_cell("granite-3-8b", "train_4k", flash_mem=True)
    rec = roofline.roofline_cell("granite-3-8b", "prefill_32k")
    assert rec["status"] == "fail" and "ROADMAP item 13b" in rec["error"]
    rec = roofline.roofline_cell("hubert-xlarge", "long_500k")
    assert rec["status"] == "skip"


def test_hardware_model_is_the_h100s_and_no_v5e_constant_remains():
    hw = roofline.HW
    assert (hw["peak_flops"], hw["hbm_bw"], hw["nvlink_bw"],
            hw["node_bw"]) == (989e12, 3.35e12, 450e9, 50e9)
    assert roofline.part_of("NVIDIA H100 80GB HBM3") == "H100 SXM"
    assert roofline.part_of("NVIDIA H100 PCIe") == "H100 PCIe"
    assert roofline.spans_nodes(range(8)) is False
    assert roofline.spans_nodes(range(16)) is True
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for const in ("197e12", "819e9", "16 GB v5e"):
            assert const not in text, (path, const)


def test_cli_runs_a_full_width_cell_on_meta(tmp_path, capsys):
    out = tmp_path / "r.jsonl"
    assert roofline.main(["--arch", "hubert-xlarge", "--shape", "train_4k",
                          "--device", "meta", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert REF_KEYS <= set(rec) and rec["status"] == "ok"
    assert rec["mesh"] == "16x16" and rec["microbatches"] == 4
    assert rec["compute_s"] > 0 and rec["memory_s"] > 0
    assert rec["collective_s"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["model_flops"] == roofline.model_flops(
        get_config("hubert-xlarge"), "train_4k")
    assert "card" not in rec
    assert "[roofline] hubert-xlarge x train_4k" in capsys.readouterr().out
