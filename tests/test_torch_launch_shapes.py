"""The port's launch shapes and production meshes against the JAX
package on the CPU (``repro_torch.launch.{mesh,shapes}`` against
``repro.launch.{mesh,shapes}``), with no compile.

- The spec tables (``param_specs``, ``state_specs``, ``cache_specs``)
  equal the reference's for all ten architectures, full and tiny (the
  embedding-input stacks carry no ``embed``; tiny recurrentgemma's
  unstacked layers), and cover the train state.
- ``cell_applicable`` equals the reference's for 10 archs x 4 shapes.
- Every leaf's global shape and dtype from ``input_specs(cfg, shape,
  None)`` equals the reference's ``jax.eval_shape`` tree (serving
  weights: ``A_log``, ``D`` and ``lam`` float32 in the port, the
  module's documented departure; the decode cache: the leaves both
  layouts share).
- On both production meshes, every leaf's spec and the spans of rank 0
  and of the last rank equal the reference's resolved ``NamedSharding``
  (``devices_indices_map`` of the first and last device of its mesh),
  read from one subprocess with 512 forced XLA devices (~40 s), run once
  for the module.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import ALL_ARCHS
from repro.launch import shapes as jshapes
from repro.models import get_config as jax_get_config
from repro.sharding import rules as jrules
from repro_torch.launch import shapes as tshapes
from repro_torch.launch.mesh import make_mesh_compat, make_production_mesh
from repro_torch.models import get_config
from repro_torch.sharding import rules as trules
from repro_torch.train import init_state
from repro_torch.tree import flatten_named

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_DUMP = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import PartitionSpec as P
from repro.configs import ALL_ARCHS
from repro.launch.mesh import make_production_mesh
from repro.launch.shapes import (SHAPES, batch_sds, cache_sds,
                                 cell_applicable, params_sds, state_sds)
from repro.models import get_config

def entry(e):
    if e is None:
        return []
    return [e] if isinstance(e, str) else list(e)

def name(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)

def span(sl, n):
    return [sl.start or 0, n if sl.stop is None else sl.stop]

def leaves(tree, mesh):
    first, last = mesh.devices.flat[0], mesh.devices.flat[-1]
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        d = {"shape": list(x.shape), "dtype": str(x.dtype)}
        sh = x.sharding
        if sh is not None:
            spec = list(sh.spec) + [None] * (len(x.shape) - len(sh.spec))
            idx = sh.devices_indices_map(tuple(x.shape))
            d["spec"] = [entry(e) for e in spec]
            d["first"] = [span(s, n) for s, n in zip(idx[first], x.shape)]
            d["last"] = [span(s, n) for s, n in zip(idx[last], x.shape)]
        out[name(path)] = d
    return out

dump = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    m = "2x16x16" if mp else "16x16"
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        dump[f"state|{arch}|{m}"] = leaves(state_sds(cfg, mesh)[0], mesh)
        dump[f"params|{arch}|{m}"] = leaves(params_sds(cfg, mesh)[0], mesh)
        for shape, (seq, batch, mode) in SHAPES.items():
            if not cell_applicable(cfg, shape)[0]:
                continue
            dump[f"batch|{arch}|{shape}|{m}"] = leaves(
                batch_sds(cfg, seq, batch, mesh, mode), mesh)
            if mode != "train":
                dump[f"cache|{arch}|{shape}|{m}"] = leaves(
                    cache_sds(cfg, batch, seq, mesh)[0], mesh)
json.dump(dump, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def ref_dump(tmp_path_factory):
    out = tmp_path_factory.mktemp("launch_shapes") / "ref.json"
    script = out.parent / "dump.py"
    script.write_text(_DUMP)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, str(script), str(out)], env=env,
                       capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(out.read_text())


def _jspecs(tree):
    from jax.sharding import PartitionSpec as JP

    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _tspecs(tree):
    return [tuple(s) for _, s in flatten_named(tree)]


def _entries(spec, ndim):
    out = []
    for e in list(spec) + [None] * (ndim - len(spec)):
        out.append([] if e is None else [e] if isinstance(e, str)
                   else list(e))
    return out


# --------------------------------------------------------------------------
# spec tables (a repair: embedding inputs and the unstacked layout)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("tiny", [False, True])
def test_spec_tables_equal_the_reference_for_every_arch(arch, tiny):
    j, t = jax_get_config(arch, tiny=tiny), get_config(arch, tiny=tiny)
    for tp in (1, 2, 16):
        for ep in (False, True, 2):
            assert _tspecs(trules.param_specs(t, tp, ep)) == \
                _jspecs(jrules.param_specs(j, tp, ep)), (tp, ep)
        assert _tspecs(trules.cache_specs(t, tp)) == \
            _jspecs(jrules.cache_specs(j, tp))
    st = init_state(t, seed=0, device="meta")
    assert [n for n, _ in flatten_named(st)] == \
        [n for n, _ in flatten_named(trules.state_specs(t, 2, False))]


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------

def test_production_meshes_are_the_references():
    for mp, shape, axes in ((False, (16, 16), ("data", "model")),
                            (True, (2, 16, 16), ("pod", "data", "model"))):
        m = make_production_mesh(multi_pod=mp)
        assert m.devices.shape == shape and m.axis_names == axes
        assert m.rank is None and m.device_mesh is None
        assert m.ranks() == list(range(int(np.prod(shape))))
    m = make_mesh_compat((2, 3), ("a", "b"))
    assert m.devices.tolist() == [[0, 1, 2], [3, 4, 5]]


def test_cell_applicable_equals_the_reference():
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    assert tshapes.SHAPES == jshapes.SHAPES
    assert tshapes.SERVE_FSDP_THRESHOLD_BYTES == \
        jshapes.SERVE_FSDP_THRESHOLD_BYTES
    for arch in ALL_ARCHS:
        for shape in jshapes.SHAPES:
            assert tshapes.cell_applicable(get_config(arch), shape) == \
                jshapes.cell_applicable(jax_get_config(arch), shape), \
                (arch, shape)


def _cache_pairs(cfg, port_cache, ref_leaves):
    """(port leaf, reference leaf with its layer axis dropped) for the
    leaves both cache layouts share."""
    P_ = len(cfg.pattern)
    for name, x in flatten_named(port_cache):
        parts = name.split(".")
        if parts[0] != "layers" or parts[-1] not in ("k", "v", "conv", "h"):
            continue
        i = int(parts[1])
        key = f"blocks.l{i % P_}.{parts[-1]}"
        yield name, x, ref_leaves[key], i // P_


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_global_shapes_and_dtypes_equal_the_reference(ref_dump, arch):
    cfg = get_config(arch)
    for shape, (seq, batch, mode) in tshapes.SHAPES.items():
        if not tshapes.cell_applicable(cfg, shape)[0]:
            with pytest.raises(ValueError, match="not applicable"):
                tshapes.input_specs(cfg, shape, None)
            continue
        m, args, shs = tshapes.input_specs(cfg, shape, None)
        assert m == mode and all(s is None for s in shs)
        names = (["state", "batch"] if mode == "train"
                 else ["params", "batch", "cache"])
        for kind, tree in zip(names, args):
            key = (f"{kind}|{arch}|16x16" if kind in ("state", "params")
                   else f"{kind}|{arch}|{shape}|16x16")
            ref = ref_dump[key]
            if kind == "cache":
                pairs = list(_cache_pairs(cfg, tree, ref))
                assert pairs
                for name, x, r, _ in pairs:
                    assert list(x.shape) == r["shape"][1:], name
                    assert _dtype(x) == r["dtype"], name
                continue
            got = {n: x for n, x in flatten_named(tree)}
            assert sorted(got) == sorted(ref), (kind, arch, shape)
            for n, x in got.items():
                assert x.device.type == "meta"
                assert list(x.shape) == ref[n]["shape"], (kind, n)
                want = ref[n]["dtype"]
                if kind == "params" and n.rsplit(".", 1)[-1] in (
                        "A_log", "D", "lam"):
                    # the port serves the recurrence leaves in float32
                    assert (_dtype(x), want) == ("float32", "bfloat16"), n
                    continue
                assert _dtype(x) == want, (kind, n)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_shards_equal_the_references_on_production_meshes(ref_dump,
                                                          multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    m = "2x16x16" if multi_pod else "16x16"
    last = mesh.ranks()[-1]
    checked = 0
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        for shape, (seq, batch, mode) in tshapes.SHAPES.items():
            if not tshapes.cell_applicable(cfg, shape)[0]:
                continue
            _, args, shs = tshapes.input_specs(cfg, shape, mesh)
            names = (["state", "batch"] if mode == "train"
                     else ["params", "batch", "cache"])
            for kind, tree, sh in zip(names, args, shs):
                key = (f"{kind}|{arch}|{m}" if kind in ("state", "params")
                       else f"{kind}|{arch}|{shape}|{m}")
                ref = ref_dump[key]
                by_name = dict(flatten_named(sh))
                if kind == "cache":
                    for name, x, r, g in _cache_pairs(cfg, tree, ref):
                        s = by_name[name]
                        assert _entries(s.spec, x.dim()) == r["spec"][1:]
                        assert s.spans(x.shape, 0) == r["first"][1:], name
                        assert s.spans(x.shape, last) == r["last"][1:]
                        checked += 1
                    continue
                for name, x in flatten_named(tree):
                    s, r = by_name[name], ref[name]
                    assert _entries(s.spec, x.dim()) == r["spec"], \
                        (arch, shape, kind, name)
                    assert s.spans(x.shape, 0) == r["first"], (arch, name)
                    assert s.spans(x.shape, last) == r["last"], (arch, name)
                    checked += 1
    assert checked > 1000


def test_shard_bytes_sum_the_shards():
    cfg = get_config("granite-3-8b", tiny=True)
    mesh = make_mesh_compat((2, 2), ("data", "model"))
    st, sh = tshapes.state_sds(cfg, mesh)
    total = 0
    for r in mesh.ranks():
        shapes = tshapes.shard_shapes(st, sh, r)
        total += tshapes.shard_bytes(st, sh, r)
        assert set(shapes) == {n for n, _ in flatten_named(st)}
    # the four ranks hold a leaf split over w of them 4 / w times
    want = 0
    for (n, x), (_, s) in zip(flatten_named(st), flatten_named(sh)):
        w = int(np.prod([mesh.shape[a]
                         for a in sum(s.dim_axes(x.dim()), ())] or [1]))
        want += x.numel() * x.element_size() * (4 // w)
    assert total == want
