"""The port's elastic meshes against the JAX package on the CPU.

- Grid math (``largest_grid``, ``best_grid3d``, legal widths, the batch
  rescaling) equals the reference's over a sweep of inputs, exactly
  (the reference's cases: tests/test_elastic_3d.py and
  tests/test_elastic_mesh.py), and ``survivor_mesh3d`` places ranks as
  the reference places devices (a subprocess with 8 forced XLA devices).
- The spec tables (``param_specs``, ``state_specs``, ``cache_specs``)
  equal the reference's for every port architecture, tp width and MoE
  mode.
- On gloo ranks (``sharding/launch.py``, one process a rank, a FileStore
  in tmp_path): the mesh train step equals the single-rank step; the
  elastic loop's 2D shrink and grow and the 3D host kill with degraded
  experts keep the reference's invariants (the events, the survivor
  grid, the manifest's mesh, no lost steps, the trajectory of an
  uninterrupted single-rank run within 0.15); every host dead raises
  ``NoSurvivorsError`` on every rank; ``compressed_psum`` over 2 and 4
  ranks is the reference's math; the train CLI runs on a 2 x 2 mesh.

The heartbeat E2Es use a 40 x 0.05 s timeout and wait on the monitor's
verdict with a deadline, never on a sleep.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from repro.core import elastic as jel
from repro.core.codec import Int8BlockCodec
from repro.models import get_config as jax_get_config
from repro.optim import compress as jcomp
from repro.sharding import rules as jrules
from repro_torch.chaos import invariants as inv
from repro_torch.core import elastic as tel
from repro_torch.models import get_config
from repro_torch.sharding import rules as trules
from repro_torch.sharding.launch import spawn
from repro_torch.tree import flatten_named

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCHS = ("granite-3-8b", "gemma2-27b", "falcon-mamba-7b", "mixtral-8x7b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# grid math
# --------------------------------------------------------------------------

def _call(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:                  # the same refusals, by name
        return ("raise", type(e).__name__)


def _both(fn_name, *args, **kw):
    return [_call(getattr(mod, fn_name), *args, **kw) for mod in (jel, tel)]


def test_largest_grid_equals_the_reference():
    for n in range(0, 17):
        for model_axis in (1, 2, 3, 4, 8):
            for legal in (None, (1, 2), (1, 2, 4), (3,), ()):
                a, b = _both("largest_grid", n, model_axis, legal=legal)
                assert a == b, (n, model_axis, legal, a, b)


def test_best_grid3d_equals_the_reference():
    for experts in (0, 1, 2, 4, 8):
        for legal_model in (None, (1, 2), (1, 2, 4)):
            for legal_data in (None, (1, 2, 4), (1, 2, 4, 8, 16, 32, 64)):
                kw = dict(data=2, model=2, expert=2, legal_model=legal_model,
                          legal_data=legal_data, num_experts=experts)
                for n in range(0, 17):
                    a = _call(jel.best_grid3d, n, jel.MeshSpec(**kw))
                    b = _call(tel.best_grid3d, n, tel.MeshSpec(**kw))
                    assert a == b, (n, kw, a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_spec_and_legal_widths_equal_the_reference(arch):
    for tiny in (False, True):
        j, t = jax_get_config(arch, tiny=tiny), get_config(arch, tiny=tiny)
        assert trules.legal_tp_widths(t) == jrules.legal_tp_widths(j)
        assert trules.legal_dp_widths(t) == jrules.legal_dp_widths(j)
        for mw in (2, 4, 16):
            assert trules.legal_tp_widths(t, mw) == \
                jrules.legal_tp_widths(j, mw)
            assert trules.legal_dp_widths(t, mw) == \
                jrules.legal_dp_widths(j, mw)
        a = jel.MeshSpec.from_config(j, data=2, model=2, expert=2)
        b = tel.MeshSpec.from_config(t, data=2, model=2, expert=2)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for n in range(1, 17):
            assert jel.best_grid3d(n, a) == tel.best_grid3d(n, b)


def test_rescale_global_batch_equals_the_reference():
    for gb in (1, 4, 8, 12, 16):
        for old in (1, 2, 3, 4):
            for new in (0, 1, 2, 4):
                a, b = _both("rescale_global_batch", gb, old, new)
                assert a == b, (gb, old, new)
    shapes = [(("data", "model"), (2, 2)), (("data", "model", "expert"),
                                            (2, 2, 2)),
              (("pod", "data", "model"), (2, 2, 1)),
              (("model",), (4,))]
    for names_a, shape_a in shapes:
        for names_b, shape_b in shapes:
            ma = SimpleNamespace(axis_names=names_a,
                                 devices=np.zeros(shape_a))
            mb = SimpleNamespace(axis_names=names_b,
                                 devices=np.zeros(shape_b))
            ta = tel.Mesh(np.arange(np.prod(shape_a)).reshape(shape_a),
                          names_a)
            tb = tel.Mesh(np.arange(np.prod(shape_b)).reshape(shape_b),
                          names_b)
            assert tel.dp_width(ta) == jel.dp_width(ma)
            a = _both("rescale_global_batch_for_mesh", 16, ma, mb)[0]
            assert a == ("ok", tel.rescale_global_batch_for_mesh(16, ta, tb))


_PLACEMENT = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.core.elastic import MeshSpec, survivor_mesh, survivor_mesh3d
from repro.models import get_config
devs = jax.devices()
out = []
for survivors in ([0,1,2,3,4,5,6,7], [0,1,4,5,6,7], [0,1,2,3], [2,3,6,7],
                  [0,1,2,3,4,5]):
    for cfg in ("mixtral-8x7b", "granite-3-8b"):
        spec = MeshSpec.from_config(get_config(cfg, tiny=True), data=2,
                                    model=2, expert=2)
        m = survivor_mesh3d([devs[i] for i in survivors], spec)
        out.append([survivors, cfg, "3d", m.axis_names,
                    [[[d.id for d in r] for r in p] for p in m.devices]])
    m = survivor_mesh([devs[i] for i in survivors], model_axis=2)
    out.append([survivors, None, "2d", m.axis_names,
                [[d.id for d in r] for r in m.devices]])
print(json.dumps(out))
"""


def test_survivor_meshes_place_ranks_as_the_reference_places_devices():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", _PLACEMENT], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    for survivors, cfg, kind, names, grid in json.loads(
            p.stdout.strip().splitlines()[-1]):
        if kind == "3d":
            spec = tel.MeshSpec.from_config(get_config(cfg, tiny=True),
                                            data=2, model=2, expert=2)
            m = tel.survivor_mesh3d(survivors, spec)
        else:
            m = tel.survivor_mesh(survivors, model_axis=2)
        assert m.axis_names == tuple(names)
        assert m.devices.tolist() == grid, (survivors, cfg, kind)


# --------------------------------------------------------------------------
# spec tables
# --------------------------------------------------------------------------

def _jspecs(tree):
    from jax.sharding import PartitionSpec

    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    from repro.core.checkpoint import _leaf_name

    return {_leaf_name(p): tuple(s) for p, s in flat}


def _tspecs(tree):
    return {n: tuple(s) for n, s in flatten_named(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tables_equal_the_reference(arch):
    j, t = jax_get_config(arch), get_config(arch)
    for tp in (0, 1, 2, 4, 16):
        for ep in (False, True, 2):
            assert _tspecs(trules.param_specs(t, tp, ep)) == \
                _jspecs(jrules.param_specs(j, tp, ep)), (tp, ep)
            assert _tspecs(trules.state_specs(t, tp, ep)) == \
                _jspecs(jrules.state_specs(j, tp, ep)), (tp, ep)
        assert _tspecs(trules.cache_specs(t, tp)) == \
            _jspecs(jrules.cache_specs(j, tp))
    assert tuple(trules.batch_spec(2)) == tuple(jrules.batch_spec(2))
    assert tuple(trules.res_spec(t)) == tuple(jrules.res_spec(j))


def test_spec_tables_cover_the_train_state():
    """Every leaf of the port's train state has a spec and no spec is
    left over (MoE and dense)."""
    from repro_torch.train import init_state

    for arch in ("granite-3-8b", "mixtral-8x7b", "gemma2-27b"):
        cfg = get_config(arch, tiny=True)
        st = init_state(cfg, seed=0, device="meta")
        names = [n for n, _ in flatten_named(st)]
        assert names == [n for n, _ in
                         flatten_named(trules.state_specs(cfg, 2, 2))]


# --------------------------------------------------------------------------
# ranks: the mesh step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,grid,micro", [
    ("granite-3-8b", (2, 2), 1), ("granite-3-8b", (2, 2), 2),
    ("mixtral-8x7b", (2, 2, 2), 1), ("granite-3-8b", (1, 1), 1),
    # the families and layouts the step took later: kv heads that tp
    # does not divide (granite's 2 over tp 4: whole, summed over
    # "model"), SSM channels over "model" (in_proj's x and z columns),
    # RG-LRU with padded q heads (3 of 4 real, so rank 1 masks its
    # second head) in the unstacked layout, embedding
    # inputs with M-RoPE and with BIDIR layers, and the "pod" axis
    ("granite-3-8b", (1, 4), 1), ("falcon-mamba-7b", (1, 2), 1),
    ("recurrentgemma-2b", (1, 2), 1), ("qwen2-vl-2b", (2, 2), 1),
    ("hubert-xlarge", (2, 2), 1), ("granite-3-8b", (2, 1, 2), 1)],
    ids=["granite-2x2", "granite-2x2-micro2", "mixtral-2x2x2",
         "granite-1x1", "granite-1x4-kv-whole", "falcon-mamba-1x2",
         "recurrentgemma-1x2", "qwen2-vl-2x2", "hubert-2x2",
         "granite-pod-2x1x2"])
def test_mesh_step_equals_the_single_rank_step(tmp_path, arch, grid, micro):
    """float32: the mesh step's metrics and state within 2e-5 of the
    single-rank step's (a 1 x 1 mesh: bit for bit), every rank agreeing,
    the donated (in-place) update bit-equal to the functional one."""
    n = int(np.prod(grid))
    axes = ("pod", "data", "model") if arch == "granite-3-8b" and \
        len(grid) == 3 else None
    cfg_kw = (dict(num_heads=3, pad_heads_to=4)
              if arch == "recurrentgemma-2b" else None)
    out = spawn(W.mesh_vs_one, n, run_dir=str(tmp_path),
                args=(arch, grid, 3, micro, axes, cfg_kw), join_timeout=300)
    for r in out:
        assert r["mesh"] == out[0]["mesh"]          # every rank agrees
        np.testing.assert_allclose(r["mesh"], r["one"], rtol=2e-5,
                                   atol=2e-5)
        assert r["state_diff"] < (1e-5 if n > 1 else 1e-30)
        assert r["donated_equal"] and r["donated_metrics_equal"]


# --------------------------------------------------------------------------
# ranks: run_elastic
# --------------------------------------------------------------------------

def _elastic(tmp_path, mode, n):
    return spawn(W.elastic, n, run_dir=str(tmp_path / "run"),
                 args=(str(tmp_path / "ckpt"), mode), join_timeout=300)


def _losses(rec):
    return [h["loss"] for h in rec["history"] if "loss" in h]


def test_elastic_shrink_matches_uninterrupted_run(tmp_path):
    """Host 1's beats stop at step 3: the mesh shrinks (2, 2) -> (1, 2),
    reshards from the pause's checkpoint, the 2 per-shard data cursors
    remap onto 1, and the loss history matches an uninterrupted
    single-rank run."""
    out = _elastic(tmp_path, "shrink", 4)
    ref = W.single_rank_losses("granite-3-8b", 10, 16, 4)
    for r in out:
        assert r["status"] == "done"
        assert [(e["kind"], e["hosts"], e["step"], e["dp"])
                for e in r["events"]] == [("shrink", (1,), 3, 1)]
        # the survivors restored 2 per-shard cursors onto 1 shard
        assert r["data"] == ([1, 2] if r["member"] else [1, None])
    lead = out[0]
    assert lead["member"] and not out[2]["member"]
    losses = _losses(lead)
    assert bool(inv.check_no_lost_steps(lead["history"], 10))
    assert len(losses) == 10
    tm = inv.check_trajectory_match(losses, ref, tol=0.15)
    assert bool(tm), tm
    assert lead["meta"] == {"dp": 1, "tp": 2, "ep": 1, "moe_ep": False,
                            "dead_experts": []}


def test_elastic_grow_on_rejoin(tmp_path):
    """Shrink at step 3, then host 1 beats again: the loop pauses at a
    boundary and grows the mesh back to (2, 2); host 1's ranks restore
    their shards and train to the end."""
    out = _elastic(tmp_path, "grow", 4)
    ref = W.single_rank_losses("granite-3-8b", 14, 16, 4)
    for r in out:
        assert r["status"] == "done" and r["dp"] == 2
        assert [e["kind"] for e in r["events"]] == ["shrink", "grow"]
        assert r["data"][0] == 2
        assert r["member"]
    losses = _losses(out[0])
    assert len(losses) == 14
    assert bool(inv.check_no_lost_steps(out[0]["history"], 14))
    assert bool(inv.check_trajectory_match(losses, ref, tol=0.15))
    grow = out[0]["events"][1]["step"]
    # host 1 ran up to its failure and again from the grow on
    assert len(_losses(out[2])) == 3 + 14 - grow


def test_elastic_3d_host_kill_degrades_experts(tmp_path):
    """The reference's acceptance scenario (tests/test_elastic_3d.py):
    tiny mixtral on (data=2, model=2, expert=2) over 4 hosts x 2 ranks,
    host 1 killed at step 3.  The survivor grid is the best legal one
    (2, 2, 1), expert slice 0 is dropped (experts 0 and 1, 2 live), the
    manifest records the grid, and the trajectory matches an
    uninterrupted single-rank run that degrades the same experts at the
    same step."""
    out = _elastic(tmp_path, "3d", 8)
    spec = tel.MeshSpec.from_config(get_config("mixtral-8x7b", tiny=True),
                                    data=2, model=2, expert=2)
    want_grid = tel.best_grid3d(6, spec.with_experts(2))
    assert want_grid == jel.best_grid3d(6, jel.MeshSpec.from_config(
        jax_get_config("mixtral-8x7b", tiny=True), data=2, model=2,
        expert=2).with_experts(2))
    lead = out[0]
    ev = lead["events"]
    assert [(e["kind"], e["hosts"]) for e in ev] == [("shrink", (1,))]
    assert (ev[0]["dp"], ev[0]["tp"], ev[0]["ep"]) == want_grid == (2, 2, 1)
    deg = [h for h in lead["history"]
           if str(h.get("event", "")).startswith("degraded_experts")]
    assert [h["event"] for h in deg] == ["degraded_experts:0,1:live=2"]
    assert lead["meta"] == {"dp": 2, "tp": 2, "ep": 1, "moe_ep": 1,
                            "dead_experts": [0, 1]}
    fail_step = deg[0]["step"]
    ref = W.single_rank_losses("mixtral-8x7b", 8, 4, 12, dead_at=fail_step,
                               dead=(0, 1))
    losses = _losses(lead)
    assert bool(inv.check_no_lost_steps(lead["history"], 8))
    tm = inv.check_trajectory_match(losses, ref, tol=0.15)
    assert bool(tm), tm
    assert sum(r["member"] for r in out) == 4     # 2 survivors idle


def test_elastic_all_hosts_dead_raises_no_survivors(tmp_path):
    out = _elastic(tmp_path, "dead", 4)
    assert all(r.get("error") == "NoSurvivorsError" for r in out), out


@pytest.mark.parametrize("n", [2, 4])
def test_reduce_scatter_is_the_ordered_sum_of_each_slice(tmp_path, n):
    """The FSDP gradient's reduce-scatter gives each rank the bits of the
    group-order sum on its slice (float32 and bfloat16, uneven and empty
    slices), as the all-gathered sum does, and that sum is every rank's
    tensor added in group order."""
    out = spawn(W.reduce_scatter_vs_sum, n, run_dir=str(tmp_path),
                args=(3,), join_timeout=300)
    for r in out:
        assert all(v for v in r if isinstance(v, bool)), r


# --------------------------------------------------------------------------
# ranks: compressed_psum
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_is_the_reference_math(tmp_path, n):
    """Each rank's int8 payload is ``Int8BlockCodec``'s bytes; the reduced
    value is the rank-order mean of the peers' dequantized payloads, the
    same bits on every rank, within one quantization step of the
    reference's jitted math; the residual is ``g_eff - deQ(Q(g_eff))``
    exactly; and error feedback makes the long-run mean of the reduced
    values converge to the true mean (tests/test_codec_compress.py)."""
    rounds = 8
    out = spawn(W.compress, n, run_dir=str(tmp_path), args=(0, rounds,
                                                             (1000, (7, 300))),
                join_timeout=300)
    codec = Int8BlockCodec()
    for k in ("a", "b"):
        for t in range(rounds):
            recs = [out[r][t][k] for r in range(n)]
            deq = []
            for rec in recs:
                g_eff = rec["g"].astype(np.float32) + rec["ef"]
                payload, meta = codec.encode(g_eff)
                nb = meta["blocks"]
                assert np.array_equal(rec["q"].reshape(-1).view(np.uint8),
                                      payload[:nb * 256])
                assert np.array_equal(rec["s"].view(np.uint8),
                                      payload[nb * 256:])
                d = codec.decode(payload, meta)
                np.testing.assert_array_equal(rec["new_ef"], g_eff - d)
                deq.append(d)
            acc = deq[0].copy()
            for d in deq[1:]:
                acc = acc + d
            want = acc / n
            for rec in recs:
                np.testing.assert_array_equal(rec["red"], want)
            # the reference's jnp math on the same inputs
            jred = sum(np.asarray(jcomp.dequantize_int8(
                *jcomp.quantize_int8(jnp.asarray(rec["g"] + rec["ef"]))))
                for rec in recs) / n
            step = max(float(np.abs(rec["g"] + rec["ef"]).max()) / 127.0
                       for rec in recs)
            assert np.abs(recs[0]["red"] - jred).max() <= step + 1e-7
    # long-run mean: the error-feedback residual keeps the sum unbiased
    for k in ("a", "b"):
        got = sum(out[0][t][k]["red"] for t in range(rounds))
        true = sum(sum(out[r][t][k]["g"] for r in range(n)) / n
                   for t in range(rounds))
        resid = sum(out[r][rounds - 1][k]["new_ef"] for r in range(n)) / n
        np.testing.assert_allclose(got + resid, true, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# the train CLI on a mesh
# --------------------------------------------------------------------------

def test_train_cli_on_a_2x2_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--tiny",
         "--device", "cpu", "--data-par", "2", "--model-par", "2",
         "--steps", "8", "--seq-len", "16", "--global-batch", "4",
         "--policy", "every_n", "--every-n", "2", "--inject-failure", "5",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "[train] done" in p.stdout and "on 2x2 ranks" in p.stdout
    assert "restarts=1" in p.stdout
    assert p.stdout.count("[train] done") == 1       # rank 0 prints
