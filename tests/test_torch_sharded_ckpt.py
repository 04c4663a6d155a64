"""Sharded checkpoints of the port (``core/checkpoint.py`` with
``shardings=``) on gloo ranks, against the JAX package.

- A rank's shard spans and replica ids are the reference's: the spans
  ``jax.Array.addressable_shards`` reports on forced XLA devices for the
  same mesh and spec (a subprocess), and GSPMD's split of an uneven dim
  (``ceil(n / w)``, the last shard short or empty) where the reference's
  ``device_put`` refuses one.
- A save on one mesh restores bit-equal onto another (more ranks, fewer,
  one), odd dims included; delta chains and the int8 codec work per shard.
- A reference checkpoint written on 4 forced XLA devices restores in the
  port, whole and onto a rank mesh; a port checkpoint written by 4 ranks
  restores in the reference (``CheckpointManager(num_hosts=4)``), also
  the state of the families the mesh step took later (a Mamba stack's
  SSM channels over "model"; RG-LRU in the unstacked layout with padded
  q heads and kv heads stored whole), saved after a mesh step, into
  the reference's own train-state layout.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from repro.core import CheckpointManager as JaxCheckpointManager
from repro.core.codec import Int8BlockCodec
from repro_torch.core import CheckpointManager
from repro_torch.models import get_config
from repro_torch.sharding.api import Mesh, NamedSharding, P, chunk_span
from repro_torch.sharding.launch import spawn
from repro_torch.train import init_state
from repro_torch.tree import flatten_named

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


_SPANS = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.loads(os.environ["CASES"])
out = []
for shape_m, names, spec, shape in cases:
    n = int(np.prod(shape_m))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape_m), tuple(names))
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    a = jax.device_put(np.zeros(shape, np.float32), NamedSharding(mesh, spec))
    rows = {}
    for sh in a.addressable_shards:
        spans = [[s.start or 0, s.stop if s.stop is not None else d]
                 for s, d in zip(sh.index, shape)]
        rows[sh.device.id] = [spans, sh.replica_id]
    out.append(rows)
print(json.dumps(out))
"""

CASES = [
    [[2, 2], ["data", "model"], ["data", "model"], [8, 6]],
    [[2, 2], ["data", "model"], [None, "model"], [4, 6]],
    [[2, 2], ["data", "model"], ["model", None], [6, 4]],
    [[2, 2], ["data", "model"], [["data", "model"], None], [8, 3]],
    [[2, 2, 2], ["data", "model", "expert"], ["expert", "data", "model"],
     [4, 6, 8]],
    [[2, 2, 2], ["data", "model", "expert"], [None, None], [3, 5]],
    [[4, 2], ["data", "model"], [None, "model", "data"], [2, 4, 8]],
    [[1, 4], ["data", "model"], ["model"], [16]],
]


def test_spans_and_replica_ids_equal_the_reference():
    p = subprocess.run([sys.executable, "-c", _SPANS],
                       env=dict(_env(), CASES=json.dumps(CASES)),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    got_all = json.loads(p.stdout.strip().splitlines()[-1])
    for (shape_m, names, spec, shape), want in zip(CASES, got_all):
        n = int(np.prod(shape_m))
        mesh = Mesh(np.arange(n).reshape(shape_m), names)
        sh = NamedSharding(mesh, P(*[tuple(e) if isinstance(e, list) else e
                                     for e in spec]))
        for dev, (spans, rid) in want.items():
            assert sh.spans(shape, rank=int(dev)) == spans, (spec, dev)
            assert sh.replica_id(rank=int(dev)) == rid, (spec, dev)


def test_uneven_dims_split_as_gspmd_pads_them():
    assert [chunk_span(7, 2, i) for i in range(2)] == [(0, 4), (4, 7)]
    assert [chunk_span(5, 4, i) for i in range(4)] == [(0, 2), (2, 4),
                                                       (4, 5), (5, 5)]
    assert [chunk_span(49155, 2, i) for i in range(2)] == [(0, 24578),
                                                           (24578, 49155)]
    mesh = Mesh(np.arange(4).reshape(2, 2), ("data", "model"))
    sh = NamedSharding(mesh, P("model", "data"))
    tiles = sorted(tuple(map(tuple, sh.spans((7, 5), rank=r)))
                   for r in range(4))
    assert tiles == [((0, 4), (0, 3)), ((0, 4), (3, 5)),
                     ((4, 7), (0, 3)), ((4, 7), (3, 5))]


# --------------------------------------------------------------------------
# cross-mesh restores on ranks
# --------------------------------------------------------------------------

LEAVES = {
    "w": np.arange(60, dtype=np.float32).reshape(6, 10),
    "v": np.arange(35, dtype=np.float32).reshape(7, 5) * 0.5,   # odd
    "e": np.arange(5, dtype=np.int32),                           # odd
    "big": np.linspace(-3, 3, 2048 * 3, dtype=np.float32).reshape(3, 2048),
    "s": np.array(7, dtype=np.int32),
}
SPEC_A = {"w": ["data", "model"], "v": ["model", None], "e": ["data"],
          "big": [None, "model"], "s": []}
SPEC_B = {"w": [None, "model"], "v": [None, "model"], "e": ["model"],
          "big": ["model", "data"], "s": []}


def _shapes():
    return {k: (list(v.shape), str(v.dtype)) for k, v in LEAVES.items()}


def _check_restored(out, want_fn):
    for r in out:
        for k, (arr, spans) in r["leaves"].items():
            sl = tuple(slice(a, b) for a, b in spans)
            np.testing.assert_array_equal(arr, want_fn(k)[sl], err_msg=k)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """One sharded save of LEAVES on a (2, 2) mesh of 4 ranks."""
    root = tmp_path_factory.mktemp("sharded")
    ck = str(root / "ckpt")
    info = spawn(W.ckpt_save, 4, run_dir=str(root / "a"),
                 args=(ck, (2, 2), LEAVES, SPEC_A), join_timeout=300)
    return ck, info


@pytest.mark.parametrize("grid_b,spec_b", [((1, 2), SPEC_B), ((4, 1), SPEC_A),
                                           ((1, 1), SPEC_B)],
                         ids=["1x2", "4x1", "one"])
def test_save_on_one_mesh_restores_bit_equal_on_another(tmp_path, saved,
                                                        grid_b, spec_b):
    ck, info = saved
    # "v" (7 rows over "model" 2): shards of 4 and 3 rows
    assert sorted(tuple(map(tuple, i["spans"]["v"])) for i in info)[0] == \
        ((0, 4), (0, 5))
    # a leaf replicated over "data" is written once (replica 0)
    assert sorted(i["replica"]["v"] for i in info) == [0, 0, 1, 1]
    n = int(np.prod(grid_b))
    out = spawn(W.ckpt_restore, n, run_dir=str(tmp_path / "b"),
                args=(ck, grid_b, _shapes(), spec_b), join_timeout=300)
    _check_restored(out, lambda k: LEAVES[k])
    meta = CheckpointManager(ck).manifest_meta(1)
    assert meta == {"grid": [2, 2]}


def test_delta_chains_and_int8_shards_restore_across_meshes(tmp_path):
    ck = str(tmp_path / "delta")
    spawn(W.ckpt_save, 4, run_dir=str(tmp_path / "a"),
          args=(ck, (2, 2), LEAVES, SPEC_A, None, True, (1, 2, 3)),
          join_timeout=300)
    man = json.load(open(os.path.join(ck, "step_00000003",
                                      "manifest_h0.json")))
    assert man["kind"] == "delta"
    out = spawn(W.ckpt_restore, 2, run_dir=str(tmp_path / "b"),
                args=(ck, (1, 2), _shapes(), SPEC_B, 3), join_timeout=300)
    want3 = W.step_values(LEAVES, 2)
    _check_restored(out, lambda k: want3[k])

    ck8 = str(tmp_path / "int8")
    info = spawn(W.ckpt_save, 4, run_dir=str(tmp_path / "c"),
                 args=(ck8, (2, 2), LEAVES, SPEC_A, "int8"),
                 join_timeout=300)
    codec = Int8BlockCodec()
    want = {k: v.copy() for k, v in LEAVES.items()}
    big = np.empty_like(LEAVES["big"])
    for i in info:          # each source shard went through the codec
        sl = tuple(slice(a, b) for a, b in i["spans"]["big"])
        payload, meta = codec.encode(LEAVES["big"][sl])
        big[sl] = codec.decode(payload, meta)
    want["big"] = big
    out = spawn(W.ckpt_restore, 2, run_dir=str(tmp_path / "d"),
                args=(ck8, (1, 2), _shapes(), SPEC_B), join_timeout=300)
    _check_restored(out, lambda k: want[k])


def test_device_codec_shards_are_decoded_on_the_target_device(tmp_path):
    """A sharded save with ``device_codec`` restored onto another mesh:
    each int8 shard overlapping a rank's region reaches the rank's device
    encoded and is decoded there by the device codec (the dequantize
    kernel on the card), with the host codec's bits."""
    ck = str(tmp_path / "dev")
    info = spawn(W.ckpt_save, 4, run_dir=str(tmp_path / "a"),
                 args=(ck, (2, 2), LEAVES, SPEC_A, None, False, (1,), True),
                 join_timeout=300)
    codec = Int8BlockCodec()
    want = {k: v.copy() for k, v in LEAVES.items()}
    for i in info:
        sl = tuple(slice(a, b) for a, b in i["spans"]["big"])
        payload, meta = codec.encode(LEAVES["big"][sl])
        want["big"][sl] = codec.decode(payload, meta)
    out = spawn(W.ckpt_restore, 2, run_dir=str(tmp_path / "b"),
                args=(ck, (1, 2), _shapes(), SPEC_B, None, True),
                join_timeout=300)
    _check_restored(out, lambda k: want[k])
    # "big": rows split over "model" 2, each rank's rows overlap both
    # stored column halves; no other leaf reaches 1024 elements a shard
    assert [r["decodes"] for r in out] == [["cpu", "cpu"]] * 2


# --------------------------------------------------------------------------
# checkpoints cross between the packages across mesh shapes
# --------------------------------------------------------------------------

_JAX_WRITE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.core import CheckpointManager
from repro.launch.mesh import make_host_mesh
from repro.models import get_config
from repro.sharding.api import resolve
from repro.sharding.rules import state_specs
from repro.train import init_state
from repro.core.checkpoint import _flatten_named
cfg = get_config("granite-3-8b", tiny=True)
mesh = make_host_mesh(2, 2)
specs = state_specs(cfg, 2)
sh = jax.tree.map(lambda s: resolve(s, mesh), specs,
                  is_leaf=lambda x: x.__class__.__name__ == "PartitionSpec")
state = jax.device_put(init_state(cfg, jax.random.PRNGKey(0)), sh)
CheckpointManager(sys.argv[1]).save(5, state)
np.savez(sys.argv[2], **{n: np.asarray(v) for n, v in _flatten_named(
    jax.device_get(state))})
"""


def _granite():
    return get_config("granite-3-8b", tiny=True)


def test_reference_sharded_checkpoint_restores_in_the_port(tmp_path):
    ck, npz = str(tmp_path / "ref"), str(tmp_path / "ref.npz")
    p = subprocess.run([sys.executable, "-c", _JAX_WRITE, ck, npz],
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    man = json.load(open(os.path.join(ck, "step_00000005",
                                      "manifest_h0.json")))
    spans = [s["spans"] for s in
             man["arrays"]["params.blocks.l0.attn.wq"]["shards"]]
    assert len(spans) == 4                      # written sharded
    want = dict(np.load(npz))
    like = init_state(_granite(), seed=0, device="meta")
    state, _ = CheckpointManager(ck).restore(like=like)
    for name, leaf in flatten_named(state):
        got = leaf.numpy()
        if got.dtype != want[name].dtype:
            got = got.view(want[name].dtype)
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    # and onto a (1, 2) rank mesh: each rank's shards of the same arrays
    shapes = {n: (list(v.shape), str(v.dtype)) for n, v in want.items()
              if n.startswith("params.blocks")}
    specs = {n: ["data" if i == 1 else ("model" if i == 2 else None)
                 for i in range(len(s))] for n, (s, _) in shapes.items()}
    out = spawn(W.ckpt_restore, 2, run_dir=str(tmp_path / "b"),
                args=(ck, (1, 2), shapes, specs), join_timeout=300)
    _check_restored(out, lambda k: want[k])


def test_port_sharded_checkpoint_restores_in_the_reference(tmp_path):
    ck = str(tmp_path / "port")
    full = {n: v.numpy() for n, v in
            flatten_named(init_state(_granite(), seed=0, device="cpu"))
            if n.startswith("params.") and v.ndim}
    spec = {n: (["data"] + [None] * (v.ndim - 2) + ["model"])
            for n, v in full.items()}
    info = spawn(W.ckpt_save, 4, run_dir=str(tmp_path / "a"),
                 args=(ck, (2, 2), full, spec), join_timeout=300)
    assert len({tuple(map(tuple, i["spans"]["params.embed.tok"]))
                for i in info}) == 4
    state, _ = JaxCheckpointManager(ck, num_hosts=4).restore(step=1)

    def walk(d, prefix=""):
        for k, v in d.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                yield from walk(v, name)
            else:
                yield name, v

    got = dict(walk(state))
    assert sorted(got) == sorted(full)
    for name, v in full.items():
        np.testing.assert_array_equal(np.asarray(got[name]), v,
                                      err_msg=name)


@pytest.mark.parametrize("arch,cfg_kw", [
    ("falcon-mamba-7b", None),
    ("recurrentgemma-2b", {"num_heads": 3, "pad_heads_to": 4})],
    ids=["falcon-mamba", "recurrentgemma"])
def test_widened_family_mesh_checkpoint_restores_in_the_reference(
        tmp_path, arch, cfg_kw):
    """One mesh step on (1, 2) ranks, a sharded save; the reference
    restores every leaf bit-equal to the port's whole state, and its
    names and shapes are the reference's train state's."""
    import dataclasses

    import jax
    from repro.models import get_config as jax_get_config
    from repro.train.state import init_state as jax_init_state

    ck = str(tmp_path / "ck")
    out = spawn(W.mesh_step_save, 2, run_dir=str(tmp_path / "r"),
                args=(ck, arch, (1, 2), cfg_kw), join_timeout=300)
    full = out[0]
    state, _ = JaxCheckpointManager(ck, num_hosts=2).restore(step=1)
    got = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(state)[0]}
    jcfg = dataclasses.replace(jax_get_config(arch, tiny=True),
                               **(cfg_kw or {}))
    ref = jax.eval_shape(lambda: jax_init_state(jcfg,
                                                jax.random.PRNGKey(0)))
    shapes = {".".join(str(getattr(k, "key", k)) for k in path): v.shape
              for path, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert sorted(got) == sorted(shapes) == sorted(full)
    for name, want in full.items():
        assert got[name].shape == shapes[name], name
        g = got[name]
        if g.dtype != want.dtype:
            g = g.view(want.dtype)
        np.testing.assert_array_equal(g, want, err_msg=name)
