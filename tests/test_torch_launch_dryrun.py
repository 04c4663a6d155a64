"""The port's dry run (``repro_torch.launch.dryrun``) and its recording
comm on the CPU: one rank's step traced on the meta device.

- The records carry the reference's keys (``repro/launch/dryrun.py``:
  ``lower_cell``'s meta and ``run_cell``'s ok, skip and fail records),
  serve cells are ``fail`` with the ROADMAP reason, the reference's
  inapplicable cells ``skip`` with its reason.
- Argument bytes are the sum of the rank's shard bytes, counted here
  from the spans.
- The recording comm's wire bytes for tiny granite (dense) and tiny
  mixtral (MoE) on a (2, 2) description mesh equal a closed form of the
  step's collectives, class by class.
- The kernels' meta outputs have the shapes and dtypes of their plain
  versions' outputs, forward and backward; a description mesh's group
  raises outside ``comm.recording``.
- One full-width cell (hubert-xlarge train_4k, ~5 s) runs through the
  CLI with ``--device meta``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rms_norm
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.launch.shapes import batch_sds, state_sds
from repro_torch.models import get_config
from repro_torch.sharding import comm
from repro_torch.tree import flatten_named

# the reference's record keys (repro/launch/dryrun.py: lower_cell's meta,
# run_cell's ok record and its skip and fail records)
REF_OK = {"arch", "shape", "mode", "mesh", "seq", "batch", "lower_s",
          "compile_s", "microbatches", "status", "memory", "cost"}
REF_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
              "peak_per_device_bytes"}
REF_COST = {"flops_per_device", "bytes_per_device"}
REF_SKIP = {"arch", "shape", "mesh", "status", "reason"}
REF_FAIL = {"arch", "shape", "mesh", "status", "error"}


def _tiny(arch):
    return dataclasses.replace(get_config(arch, tiny=True),
                               dtype=torch.float32)


def _trace(cfg, B, S):
    mesh = make_mesh_compat((2, 2), ("data", "model"))
    st, st_sh = state_sds(cfg, mesh)
    batch, b_sh = batch_sds(cfg, S, B, mesh, "train")
    rec = dryrun.trace_cell(cfg, mesh, st, batch, st_sh, b_sh,
                            microbatches=1)
    return rec, mesh, (st, st_sh), (batch, b_sh)


def _layer_matrices(cfg):
    """Elements of one layer's leaves split over "data" and "model"."""
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    h, k = cfg.effective_num_heads, cfg.num_kv_heads
    attn = d * hd * (2 * h + 2 * k)
    if cfg.num_experts:
        return attn + 3 * cfg.num_experts * d * f
    return attn + 3 * d * f


def test_wire_bytes_of_a_dense_step_are_the_closed_form():
    """Tiny granite, float32, (data 2, model 2), one microbatch of B/2
    rows a rank: the FSDP gathers (all-gather, half the gathered bytes
    on the wire), the vocab gather over "model", per layer two
    row-parallel sums forward, one again in the recomputation (which
    stops at the last tensor the backward saved, before the MLP's sum)
    and two gradient sums of the entered activations (all-reduce, G = 2:
    the output's bytes), the norms' and the embedding shard's gradient sums
    over "data", the FSDP reduce-scatters (the rank's slice), the loss
    sums over "data" and the norm over the mesh (G = 4)."""
    cfg = _tiny("granite-3-8b")
    B, S = 4, 16
    rec, *_ = _trace(cfg, B, S)
    L, D, V = cfg.num_layers, cfg.d_model, cfg.padded_vocab
    tp = dp = 2
    m = L * _layer_matrices(cfg) * 4                   # float32 bytes
    act = (B // dp) * S * D * 4
    want = {
        "all-gather": 0.5 * (m / tp) + 0.5 * V * D * 4,
        "reduce-scatter": 1.0 * m / (tp * dp),
        "all-reduce": (5 * L * act + (2 * L + 1) * D * 4 + V * D / tp * 4
                       + 3 * 4 + 1.5 * 4),
        "all-to-all": 0.0, "collective-permute": 0.0}
    want["total"] = sum(want.values())
    assert rec["collectives"] == pytest.approx(want, rel=1e-12)


def test_wire_bytes_of_an_moe_step_are_the_closed_form():
    """Tiny mixtral, float32, (data 2, model 2): the dense step's
    collectives with the experts' d_ff over "model", plus per layer the
    dispatch input's and the gate weights' gradient sums over the shard
    group, the combine's sum (forward only: the recomputation stops
    before it, as before the dense MLP's), and the aux loss's expert
    means over "data" (forward and recomputation each; the router's
    mean's gradient once)."""
    cfg = _tiny("mixtral-8x7b")
    B, S = 4, 16
    rec, *_ = _trace(cfg, B, S)
    L, D, V, E = (cfg.num_layers, cfg.d_model, cfg.padded_vocab,
                  cfg.num_experts)
    k = cfg.experts_per_token
    tp = dp = 2
    m = L * _layer_matrices(cfg) * 4
    act = (B // dp) * S * D * 4
    # embed (V/tp, D) and lm_head (D, V/tp): gathered over "model", their
    # shards' gradients summed over "data"; router and norms the same
    vocab = 2 * V * D * 4
    want = {
        "all-gather": 0.5 * (m / tp) + 0.5 * vocab,
        "reduce-scatter": 1.0 * m / (tp * dp),
        "all-reduce": (5 * L * act + L * (B // dp) * S * k * 4
                       + L * 5 * E * 4
                       + (2 * L + 1) * D * 4 + L * D * E * 4
                       + vocab / tp + 3 * 4 + 1.5 * 4),
        "all-to-all": 0.0, "collective-permute": 0.0}
    want["total"] = sum(want.values())
    assert rec["collectives"] == pytest.approx(want, rel=1e-12)


def test_argument_bytes_are_the_shards_bytes():
    cfg = _tiny("granite-3-8b")
    rec, mesh, (st, st_sh), (batch, b_sh) = _trace(cfg, 4, 16)
    total = 0
    for tree, sh in ((st, st_sh), (batch, b_sh)):
        by_name = dict(flatten_named(sh))
        for name, x in flatten_named(tree):
            spans = by_name[name].spans(x.shape, 0)
            total += int(np.prod([b - a for a, b in spans])) * \
                x.element_size()
    assert rec["memory"]["argument_bytes"] == total
    mem = rec["memory"]
    assert mem["peak_per_device_bytes"] == \
        mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["alias_bytes"] > 0 and mem["temp_bytes"] > 0


def test_description_groups_only_under_recording():
    mesh = make_mesh_compat((2, 2), ("data", "model"))
    mesh.rank = 3
    with pytest.raises(KeyError):
        mesh.group(("data", "model"))
    with comm.recording(mesh) as rec:
        g = mesh.group(("model",))
        assert isinstance(g, comm.DescGroup) and g.ranks == (2, 3)
        x = torch.arange(4.0)
        parts = comm.all_gather(x, g)
        assert torch.equal(parts[1], x) and not parts[0].any()
        assert torch.equal(comm.ordered_sum(x, g), x)
        assert torch.equal(comm.reduce_scatter(x, g, 0, [2, 2]), x[2:])
    assert [r[:3] for r in rec.records] == [
        ("all-gather", 2, 32), ("all-reduce", 2, 16),
        ("reduce-scatter", 2, 8)]
    with pytest.raises(KeyError):
        mesh.group(("model",))


def test_kernels_meta_outputs_match_their_plain_versions():
    g = torch.Generator().manual_seed(0)
    meta = torch.device("meta")

    def run(dev):
        q = torch.randn(2, 32, 4, 16, generator=g).to(dev)
        kv = torch.randn(2, 32, 2, 16, generator=g).to(dev)
        q.requires_grad_(True), kv.requires_grad_(True)
        o = flash_attention(q, kv, kv, causal=True, window=8)
        o.sum().backward()
        x = torch.randn(2, 8, 64, generator=g).to(dev).requires_grad_(True)
        w = torch.ones(64).to(dev).requires_grad_(True)
        y = rms_norm(x, w)
        y.sum().backward()
        xs = torch.randn(2, 8, 6, generator=g).to(dev).requires_grad_(True)
        bm = torch.randn(2, 8, 3, generator=g).to(dev).requires_grad_(True)
        a = (-torch.rand(6, 3, generator=g)).to(dev).requires_grad_(True)
        h0 = torch.zeros(2, 6, 3).to(dev).requires_grad_(True)
        ys, hl = selective_scan(xs, xs, bm, bm, a, h0)
        (ys.sum() + hl.sum()).backward()
        return [(tuple(t.shape), t.dtype) for t in
                (o, q.grad, kv.grad, y, x.grad, w.grad, ys, hl, xs.grad,
                 bm.grad, a.grad, h0.grad)]

    assert run(meta) == run(torch.device("cpu"))


def test_records_keys_serve_and_skip_cells():
    rec = dryrun.run_cell("granite-3-8b", "decode_32k", False,
                          verbose=False)
    assert set(rec) == REF_FAIL and rec["status"] == "fail"
    assert rec["error"] == ("no mesh serving step in the port yet "
                            "(ROADMAP item 13b)")
    rec = dryrun.run_cell("hubert-xlarge", "decode_32k", True,
                          verbose=False)
    assert set(rec) == REF_SKIP and rec["status"] == "skip"
    assert rec["reason"] == "encoder-only arch has no decode step"
    assert dryrun.microbatches_for("qwen1.5-110b", "train", 256, 32) == 8
    assert dryrun.microbatches_for("granite-3-8b", "train", 256, 16) == 4


def test_cli_runs_a_full_width_cell_on_meta(tmp_path, capsys):
    out = tmp_path / "r.jsonl"
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape", "train_4k",
                        "--device", "meta", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert REF_OK <= set(rec) and rec["status"] == "ok"
    assert REF_MEMORY <= set(rec["memory"])
    assert REF_COST <= set(rec["cost"])
    assert rec["mesh"] == "16x16" and rec["microbatches"] == 4
    assert rec["fits"] and rec["device"]["memory_bytes"] == 80e9
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["collectives"]["total"] > 0
    assert "1 cells: 1 ok, 0 skip, 0 fail in" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "hubert-xlarge", "--shape", "train_4k"])
