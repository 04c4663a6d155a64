"""The port's delta (incremental) checkpoints against the JAX package's,
on the CPU.

One save sequence (a full save, then saves after a few blocks change, a
periodic full save) is written by each package.  Both write the same
checkpoints: the same save kinds and dirty/total block counts, the same
manifests apart from the random lineage ids (``sid``), which are compared
by the step that issued them; and each package restores every step of the
other's chain bit-exactly, for raw saves and the host int8 codec.  With
the device codec the port's chain is held to ``Int8BlockCodec`` (a full
host-int8 save of the same state), the on-disk contract, as
tests/test_torch_checkpoint.py holds the full save.  Chain-aware garbage
collection, a zero-dirty save, async saves, the reset after a restore and
a regenerated parent refused by its lineage id are the reference's cases
(tests/test_delta.py) held by the port.
"""
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import CheckpointManager as JaxManager
from repro_torch.core import CheckpointManager
from repro_torch.tree import flatten_named

BLOCK = 256
BUMPS = (None, 3, 9, 3, 12, 1)             # block touched before each save
MODES = {"raw": dict(), "int8": dict(codec="int8")}


def _np_state():
    """A 4000-element float leaf (16 blocks), a bf16 leaf, an int leaf,
    a leaf under the delta floor and a scalar."""
    rng = np.random.default_rng(11)
    return {"w": rng.standard_normal((40, 100)).astype(np.float32),
            "h": rng.standard_normal(3000).astype(ml_dtypes.bfloat16),
            "ints": np.arange(5000, dtype=np.int32),
            "small": np.linspace(-1, 1, 64, dtype=np.float32),
            "step": np.asarray(0, np.int32)}


def _bump(st, block):
    st = {k: v.copy() for k, v in st.items()}
    st["w"].reshape(-1)[block * BLOCK] += 3.0
    st["h"][block * 97 % 3000] += 1.0
    st["ints"][(block * BLOCK) % 5000] += 1
    st["step"] = st["step"] + 1
    return st


def _states():
    out, st = [], _np_state()
    for b in BUMPS:
        st = st if b is None else _bump(st, b)
        out.append(st)
    return out


def _torch(st):
    out = {}
    for k, v in st.items():
        if v.dtype == ml_dtypes.bfloat16:
            out[k] = torch.from_numpy(v.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def _jax(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _assert_same(a, b):
    fa, fb = flatten_named(a), flatten_named(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        assert _bits(x) == _bits(y), n


def _write(mgr_cls, d, states, convert, **kw):
    mgr = mgr_cls(d, delta=True, delta_block=BLOCK, full_every=4, keep=10,
                  fsync="none", **kw)
    stats = [mgr.save(i + 1, convert(st)) for i, st in enumerate(states)]
    mgr.close()
    return [(s.kind, s.dirty_blocks, s.total_blocks) for s in stats]


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest_h0.json")) as f:
        man = json.load(f)
    return man


def _lineage(d, steps):
    """Each save's lineage id -> the step that issued it."""
    return {sh["sid"]: s for s in steps
            for e in _manifest(d, s)["arrays"].values()
            for sh in e["shards"]}


def _normalized(d, step, lineage):
    man = _manifest(d, step)
    for e in man["arrays"].values():
        for sh in e["shards"]:
            sh["sid"] = lineage[sh["sid"]]
            if "delta" in sh:
                sh["delta"]["parent_sids"] = {
                    k: lineage[v]
                    for k, v in sh["delta"]["parent_sids"].items()}
    return man


@pytest.mark.parametrize("mode", sorted(MODES))
def test_delta_chains_cross_restore_bit_exactly(tmp_path, mode):
    states = _states()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jstats = _write(JaxManager, jdir, states, _jax, **MODES[mode])
    tstats = _write(CheckpointManager, tdir, states, _torch, **MODES[mode])
    # the same kinds and dirty/total block counts, save for save
    assert tstats == jstats
    assert [k for k, _, _ in tstats] == ["full", "delta", "delta", "delta",
                                         "full", "delta"]
    assert tstats[1][1] < tstats[1][2]
    steps = list(range(1, len(states) + 1))
    jl, tl = _lineage(jdir, steps), _lineage(tdir, steps)
    for s in steps:
        assert _normalized(tdir, s, tl) == _normalized(jdir, s, jl), s
        assert sorted(os.listdir(os.path.join(jdir, f"step_{s:08d}"))) == \
            sorted(os.listdir(os.path.join(tdir, f"step_{s:08d}")))
    like = _torch(states[0])
    kw = dict(fsync="none", **MODES[mode])
    for s, st in zip(steps, states):
        j_own, _ = JaxManager(jdir, **kw).restore(step=s)
        t_own, _ = CheckpointManager(tdir, **kw).restore(step=s, like=like)
        t_from_j, _ = CheckpointManager(jdir, **kw).restore(step=s,
                                                            like=like)
        j_from_t, _ = JaxManager(tdir, **kw).restore(step=s)
        _assert_same(t_from_j, j_own)
        _assert_same(t_own, j_from_t)
        _assert_same(t_own, j_own)
        if mode == "raw":
            _assert_same(t_own, _torch(st))


def test_device_codec_chain_matches_the_host_codec(tmp_path, monkeypatch):
    """Dirty blocks quantized on the tensor's device restore through the
    chain to the bits of a full device-codec save of the same state, the
    float32 leaves to those of a full host-int8 save (``Int8BlockCodec``,
    the on-disk contract; the host codec leaves bfloat16 raw), and the
    reference reads the port's chain to the same bits.  Every coded leaf
    of a chain is assembled encoded and decoded once by the device codec
    (the dequantize kernel on the card), never by the host codec."""
    from repro_torch.core.codec import DeviceCodec, Int8BlockCodec

    decodes = []
    dev_decode = DeviceCodec.decode
    monkeypatch.setattr(DeviceCodec, "decode", lambda self, q, s, shape: (
        decodes.append(tuple(shape)), dev_decode(self, q, s, shape))[1])
    host_decode = Int8BlockCodec.decode
    states = _states()
    tdir = str(tmp_path / "torch")
    stats = _write(CheckpointManager, tdir, states, _torch,
                   device_codec=True)
    assert [k for k, _, _ in stats][:2] == ["full", "delta"]
    like = _torch(states[0])
    for s, st in enumerate(states, start=1):
        fdir, odir = str(tmp_path / f"full{s}"), str(tmp_path / f"host{s}")
        full = CheckpointManager(fdir, device_codec=True, fsync="none")
        full.save(s, _torch(st))
        full.close()
        oracle = JaxManager(odir, codec="int8", fsync="none")
        oracle.save(s, _jax(st))
        oracle.close()
        decodes.clear()
        monkeypatch.setattr(Int8BlockCodec, "decode", None)
        got, _ = CheckpointManager(tdir, device_codec=True).restore(
            step=s, like=like)
        monkeypatch.setattr(Int8BlockCodec, "decode", host_decode)
        assert sorted(decodes) == [(40, 100), (3000,)], s
        _assert_same(got, CheckpointManager(fdir, device_codec=True)
                     .restore(step=s, like=like)[0])
        want, _ = JaxManager(odir, codec="int8").restore(step=s)
        _assert_same({k: v for k, v in got.items() if k != "h"},
                     {k: v for k, v in want.items() if k != "h"})
        _assert_same(JaxManager(tdir, codec="int8").restore(step=s)[0],
                     got)


def test_full_every_and_reset_after_restore(tmp_path):
    st = _np_state()
    mgr = CheckpointManager(str(tmp_path), delta=True, delta_block=BLOCK,
                            full_every=3, keep=20, fsync="none")
    kinds = []
    for s in range(1, 8):
        kinds.append(mgr.save(s, _torch(st)).kind)
        st = _bump(st, s % 16)
    st = _torch(st)
    assert kinds == ["full", "delta", "delta", "full", "delta", "delta",
                     "full"]
    mgr.restore(step=5, like=st)
    assert mgr.save(8, st).kind == "full"          # a restore resets
    mgr.close()


def test_gc_keeps_parents_of_retained_deltas(tmp_path):
    states = _states()
    mgr = CheckpointManager(str(tmp_path), delta=True, delta_block=BLOCK,
                            full_every=100, keep=2, fsync="none")
    for s, st in enumerate(states[:5], start=1):
        mgr.save(s, _torch(st))
    # keep=2 retains {4, 5}, whose chains reference 1..3
    assert mgr.all_steps() == [1, 2, 3, 4, 5]
    got, _, step, skipped = mgr.restore_latest(like=_torch(states[0]))
    assert step == 5 and not skipped
    _assert_same(got, _torch(states[4]))
    mgr2 = CheckpointManager(str(tmp_path), delta=True, delta_block=BLOCK,
                             full_every=1, keep=2, fsync="none")
    mgr2.save(6, _torch(states[5]))
    mgr2.save(7, _torch(states[5]))
    assert mgr2.all_steps() == [6, 7]
    for m in (mgr, mgr2):
        m.close()


def test_zero_dirty_and_async_saves(tmp_path):
    st = _torch(_np_state())
    mgr = CheckpointManager(str(tmp_path), delta=True, delta_block=BLOCK,
                            full_every=100, fsync="none")
    mgr.save(1, st, blocking=False)
    s2 = mgr.save(2, st, blocking=False)
    mgr.wait()
    assert s2.kind == "delta" and s2.dirty_blocks == 0
    files = os.listdir(tmp_path / "step_00000002")
    assert not any(f.startswith("w.s") for f in files)
    assert _manifest(str(tmp_path), 2)["arrays"]["w"]["shards"][0][
        "file"] is None
    got, _, step, _ = mgr.restore_latest(like=st)
    assert step == 2
    _assert_same(got, st)
    mgr.close()
    with pytest.raises(ValueError, match="multiple"):
        CheckpointManager(str(tmp_path), delta=True, delta_block=100)


def test_regenerated_parent_step_invalidates_stale_chain(tmp_path):
    states = [_torch(s) for s in _states()]
    mgr = CheckpointManager(str(tmp_path), delta=True, delta_block=BLOCK,
                            full_every=100, keep=10, fsync="none")
    for s in (1, 2, 3):
        mgr.save(s, states[s - 1])               # full, delta, delta
    f2 = next(f for f in os.listdir(tmp_path / "step_00000002")
              if f.startswith("w.s"))
    p = tmp_path / "step_00000002" / f2
    raw = bytearray(p.read_bytes())
    raw[-1] ^= 0xFF
    p.write_bytes(bytes(raw))
    _, _, got, _ = mgr.restore_latest(like=states[0])
    assert got == 1
    # resume: a new step 2 (full, after the restore) replaces the corrupt
    # one; the stale step 3 references the old step 2's lineage
    assert mgr.save(2, states[4]).kind == "full"
    restored, _, got, skipped = mgr.restore_latest(like=states[0])
    assert got == 2 and [s for s, _ in skipped] == [3]
    assert "regenerated" in skipped[0][1]
    _assert_same(restored, states[4])
    mgr.close()
