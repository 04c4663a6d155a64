"""The port's SDC tier 2 (block hashes, leaf checksums, the state
scrubber, bit-flip injection) against the JAX package's, on the CPU.

- Block hashes: the plain version (``kernels/block_hash/ref.py``, what a
  CPU tensor takes and what the CUDA kernel is held to on the card) is
  bit-equal to the reference's numpy oracle ``block_hashes_np`` and to
  its jnp twin over dtypes (1-, 2-, 4- and 8-byte), ragged sizes and
  block sizes; the reference's Pallas kernel (interpret mode) on a few.
- Leaf checksums, ``flip_bit`` and the scrubber: the same leaf gives the
  same checksum, the same bit flips the same byte, and the same flip
  makes both scrubbers name the same leaf.
- End to end: tiny granite in float32 through both facades with delta
  saves, the scrubber and a scheduled bit-flip: the same restarts, the
  same named leaf, the same saves, and the same loss trajectory (1e-5
  relative: the two frameworks sum in different orders), and the
  recovered run bit-equal to an uninterrupted port run.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import Dependability as JaxDependability
from repro.core import DependabilityConfig as JaxConfig
from repro.core import FaultInjector as JaxInjector
from repro.core import flip_bit as jax_flip_bit
from repro.core import run_with_recovery as jax_run_with_recovery
from repro.data import make_pipeline as jax_make_pipeline
from repro.kernels.block_hash.ops import block_hashes as jax_block_hashes
from repro.kernels.block_hash.ref import block_hashes_np
from repro.models import get_config as jax_get_config
from repro.sdc import StateScrubber as JaxScrubber
from repro.sdc import leaf_checksum as jax_leaf_checksum
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.core import (Dependability, DependabilityConfig,
                              FaultInjector, run_with_recovery)
from repro_torch.core.failures import flip_bit
from repro_torch.kernels.block_hash.ops import host_block_hashes
from repro_torch.kernels.block_hash.ref import (block_hashes_np as
                                                port_block_hashes_np)
from repro_torch.kernels.block_hash.ref import block_hashes_ref, checksum_ref
from repro_torch.models import get_config, state_from_jax
from repro_torch.sdc import StateScrubber, checksums, leaf_checksum
from repro_torch.train import make_train_step
from repro_torch.tree import flatten_named

DTYPES = ["float32", "bfloat16", "float16", "int8", "uint8", "int32",
          "int64", "float64", "bool"]
# jax here runs without 64-bit types: 8-byte leaves meet numpy only
JAX_DTYPES = {"float32", "bfloat16", "float16", "int8", "uint8", "int32"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaf(dtype, n, seed=0):
    """(numpy array, torch tensor) holding the same bytes."""
    rng = np.random.default_rng(seed + n)
    x = rng.standard_normal(n) * 1000
    if dtype == "bfloat16":
        a = x.astype(ml_dtypes.bfloat16)
        return a, torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    a = (x > 0) if dtype == "bool" else x.astype(dtype)
    return a, torch.from_numpy(a.copy())


@pytest.mark.parametrize("block", [256, 1024, 65536])
@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4097])
@pytest.mark.parametrize("dtype", DTYPES)
def test_block_hashes_match_reference(dtype, n, block):
    a, t = _leaf(dtype, n)
    want = block_hashes_np(a, block)
    got = block_hashes_ref(t, block)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(host_block_hashes([t], block)[0], want)
    assert np.array_equal(port_block_hashes_np(a, block), want)
    if dtype in JAX_DTYPES:
        jh = jax_block_hashes(jnp.asarray(a), block, use_kernel=False)
        assert np.array_equal(np.asarray(jh), want)
    assert checksum_ref(t, block) == int(want.sum(dtype=np.uint32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_block_hashes_match_reference_kernel(dtype):
    """The reference's Pallas kernel (interpret mode) on a ragged leaf."""
    a, t = _leaf(dtype, 3000)
    jh = jax_block_hashes(jnp.asarray(a), 1024, use_kernel=True,
                          interpret=True)
    assert np.array_equal(host_block_hashes([t], 1024)[0], np.asarray(jh))


def test_batched_hashes_and_noncontiguous_leaves():
    rng = np.random.default_rng(3)
    base = rng.standard_normal((70, 40)).astype(np.float32)
    leaves = [torch.from_numpy(base).t(),                # not contiguous
              torch.from_numpy(base)[1:],                 # an offset view
              torch.arange(5, dtype=torch.int64), torch.zeros(0)]
    want = [block_hashes_np(np.ascontiguousarray(x.numpy()), 256)
            for x in leaves]
    for got, w in zip(host_block_hashes(leaves, 256), want):
        assert got.dtype == np.uint32 and np.array_equal(got, w)


def test_hashes_and_abft_refuse_other_devices():
    """A CPU tensor takes the plain version; any other device (here
    ``meta``) goes to the kernel wrapper, which refuses what is not on a
    CUDA device."""
    from repro_torch.kernels.abft_matmul.ops import abft_matmul

    m = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        host_block_hashes([torch.empty(300, device=m)])
    with pytest.raises(ValueError, match="CUDA"):
        abft_matmul(torch.empty(4, 8, device=m), torch.empty(8, 3, device=m))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "uint8"])
def test_leaf_checksums_match_reference(dtype):
    a, t = _leaf(dtype, 70000)
    want = jax_leaf_checksum(jnp.asarray(a))
    assert leaf_checksum(t) == want
    # numpy leaves are crc32'd on the host in both packages
    assert leaf_checksum(np.asarray(a)) == jax_leaf_checksum(np.asarray(a))
    assert checksums([t, t.reshape(10, 7000)]) == [want, want]


def _bytes(t):
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("bit", [0, 7, 30, 31, 100, 255])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "float64"])
def test_flip_bit_is_the_references_twin(dtype, bit):
    a, t = _leaf(dtype, 32)
    ref = np.asarray(jax_flip_bit(a, bit))
    got = flip_bit(t, bit)
    assert got.dtype == t.dtype and got.shape == t.shape
    assert _bytes(got) == ref.tobytes() != _bytes(t)
    assert _bytes(flip_bit(got, bit)) == _bytes(t)      # an involution
    assert flip_bit(np.asarray(a), bit).tobytes() == ref.tobytes()
    with pytest.raises(IndexError):
        flip_bit(t, t.numel() * t.element_size() * 8)


def _ref_state(dtype="float32"):
    jcfg = dataclasses.replace(jax_get_config("granite-3-8b", tiny=True),
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(get_config("granite-3-8b", tiny=True),
                               dtype=getattr(torch, dtype))
    jstate = jax_init_state(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jstate, state_from_jax(tcfg, jax.device_get(jstate),
                                              device="cpu")


@pytest.mark.parametrize("leaf,bit", [("params.embed.tok", 30),
                                      ("params.blocks.l0.attn.wk", 3),
                                      ("opt.m.final_norm", 31),
                                      ("step", 0)])
def test_scrubbers_name_the_same_leaf(leaf, bit):
    _, _, jstate, tstate = _ref_state()
    js, ts = JaxScrubber(fraction=1.0), StateScrubber(fraction=1.0)
    js.record(jstate, 1)
    ts.record(tstate, 1)
    assert ts.full_checksums(tstate) == js.full_checksums(jstate)
    ji, ti = JaxInjector(), FaultInjector()
    ji.schedule_bitflip(2, leaf, bit)
    ti.schedule_bitflip(2, leaf, bit)
    jbad = js.verify(ji.apply_sdc(2, jstate))
    tbad = ts.verify(ti.apply_sdc(2, tstate))
    assert tbad == jbad == [leaf]
    assert ti.sdc_injected == ji.sdc_injected == [(2, leaf, bit)]
    assert ts.verify(tstate) == []                 # the original is intact
    assert ti.apply_sdc(3, tstate) is tstate       # nothing else due


def test_scrubber_rotation_and_reset_match_reference():
    _, _, jstate, tstate = _ref_state()
    js, ts = JaxScrubber(fraction=0.3), StateScrubber(fraction=0.3)
    for step in range(1, 6):
        assert ts.record(tstate, step) == js.record(jstate, step)
    ts.reset()
    assert ts.verify(tstate) == [] and ts.leaves_scrubbed == \
        js.leaves_scrubbed
    with pytest.raises(KeyError):
        inj = FaultInjector()
        inj.schedule_bitflip(1, "params.nope", 0)
        inj.apply_sdc(1, tstate)


STEPS = 9
FLIP = (5, "params.blocks.l0.attn.wk", 30)


class _RefBatches:
    """The reference pipeline's batches by step, as the port's local
    state (the port's own pipeline draws other tokens)."""

    def __init__(self, cfg, seq, batch):
        data = jax_make_pipeline(cfg, seq, batch)
        self.batches = [jax.device_get(data.next_batch())
                        for _ in range(STEPS)]
        self.step = 0

    def next_batch(self):
        b = self.batches[self.step]
        self.step += 1
        return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, d):
        self.step = int(d["step"])


def _facade_run(pkg, tmp_path, cfg, state, *, flip=True):
    dep_cls, conf_cls, inj_cls, run, pipe, step_fn = pkg
    dep = dep_cls(conf_cls(
        checkpoint_dir=str(tmp_path), policy_mode="every_n", every_n=2,
        heartbeat=False, signal_detection=False, fsync="none",
        delta_checkpoint=True, delta_block=256, full_every=3, scrub=True,
        scrub_fraction=1.0)).start()
    data = pipe(cfg, 16, 4)
    dep.register_local_state(data)
    injector = inj_cls()
    if flip:
        injector.schedule_bitflip(*FLIP)
    losses = []
    out, info = run(dep, step_fn, state, data, STEPS,
                    fault_injector=injector, like=state, max_restarts=3,
                    on_metrics=lambda s, rec: losses.append(
                        (s, rec["loss"])))
    saves = [(s.step, s.kind, s.dirty_blocks, s.total_blocks)
             for s in dep.save_history]
    dep.stop()
    events = [h["event"] for h in info["history"] if "event" in h]
    return out, info, events, losses, saves


def test_facade_sdc_run_matches_reference(tmp_path):
    jcfg, tcfg, jstate, tstate = _ref_state()
    jpkg = (JaxDependability, JaxConfig, JaxInjector, jax_run_with_recovery,
            jax_make_pipeline,
            jax.jit(jax_make_train_step(jcfg, total_steps=STEPS)))
    tpkg = (Dependability, DependabilityConfig, FaultInjector,
            run_with_recovery, lambda cfg, s, b: _RefBatches(jcfg, s, b),
            make_train_step(tcfg, total_steps=STEPS))
    _, jinfo, jev, jloss, jsaves = _facade_run(jpkg, tmp_path / "jax",
                                               jcfg, jstate)
    tout, tinfo, tev, tloss, tsaves = _facade_run(tpkg, tmp_path / "torch",
                                                  tcfg, tstate)
    assert tinfo["status"] == jinfo["status"] == "done"
    assert tinfo["restarts"] == jinfo["restarts"] == 1
    assert tev == jev == [f"corruption:scrub:{FLIP[1]}"]
    # the same saves: kinds and dirty/total blocks of every one
    assert tsaves == jsaves
    assert [s for s, _ in tloss] == [s for s, _ in jloss]
    np.testing.assert_allclose([x for _, x in tloss], [x for _, x in jloss],
                               rtol=1e-5)
    # the recovered port run ends bit-equal to an uninterrupted port run
    clean, info, ev, _, _ = _facade_run(tpkg, tmp_path / "clean", tcfg,
                                        tstate, flip=False)
    assert ev == [] and info["restarts"] == 0
    for (n, a), (_, b) in zip(flatten_named(tout), flatten_named(clean)):
        assert torch.equal(a, b), n


def test_cli_sdc_flags(tmp_path):
    """``launch.train --tiny --device cpu`` with delta saves, the scrubber,
    a scheduled bit-flip and ABFT projections: the flip is named and
    rolled back, and the status line counts full and delta saves."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--tiny",
         "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"),
         "--steps", "8", "--seq-len", "16", "--global-batch", "2",
         "--policy", "every_n", "--every-n", "2", "--delta-checkpoint",
         "--delta-block", "256", "--full-every", "3", "--scrub",
         "--scrub-fraction", "1.0", "--abft",
         "--inject-bitflip", "5:params.embed.tok:30"],
        env=env, cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[train] done in" in out.stdout and "restarts=1;" in out.stdout
    assert "checkpoints=4 (2 full + 2 delta)" in out.stdout
    assert "corruption:scrub:params.embed.tok" in out.stdout
