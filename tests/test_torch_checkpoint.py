"""The port's checkpoint format, codec and policy against the JAX
package's, on the CPU.

- Codec: the plain version of the int8 kernel (``kernels/ckpt_codec/
  ref.py``) gives the bytes of the host codec (``Int8BlockCodec.encode``,
  the on-disk contract), on cases with exact .5 ties, a zero block, a
  ragged tail and bfloat16 input.  The reference's jitted codecs (its
  Pallas kernel in interpret mode, and the jnp twin its DeviceCodec runs
  off the TPU) do not: XLA computes ``amax / 127`` as a multiply by the
  reciprocal, an ulp off the IEEE quotient for some blocks, and a q value
  next to such a scale may round the other way.  The test holds them to
  that: scales within one ulp of the port's, q within one step.
- Checkpoints, both directions, raw and int8 (host codec and device
  codec): a checkpoint written by ``repro`` restores in ``repro_torch``
  with the bits ``repro`` itself restores, and the reverse; the two
  packages write the same files (manifests equal, payload CRCs equal; a
  port device-codec checkpoint equals the reference's host-codec one, and
  the reference's device-codec one apart from the CRCs of the blocks its
  jitted codec rounds differently).
- Policy: the same observations give the same ``should_checkpoint``
  sequence for both Young/Daly formulas and the fixed interval.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import CheckpointManager as JaxManager
from repro.core import CheckpointPolicy as JaxPolicy
from repro.core import SystemModel as JaxSystem
from repro.core.codec import Int8BlockCodec as JaxInt8
from repro.core.io_engine import crc32_array as jax_crc32
from repro.kernels.ckpt_codec.ops import dequantize as pallas_dequantize
from repro.kernels.ckpt_codec.ops import quantize as pallas_quantize
from repro.models import get_config as jax_get_config
from repro.train import init_state as jax_init_state
from repro_torch.core import CheckpointManager, CheckpointPolicy, SystemModel
from repro_torch.core.codec import DeviceCodec, Int8BlockCodec
from repro_torch.core.io_engine import crc32_array
from repro_torch.kernels.ckpt_codec.ops import dequantize, quantize
from repro_torch.models import get_config, state_from_jax
from repro_torch.tree import flatten_named

CODEC_CASES = {
    "ties": 1024, "ragged": 1000, "tiny": 3, "zero_block": 4096 + 17}


def _codec_input(name):
    n = CODEC_CASES[name]
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 3.0).astype(np.float32)
    if n >= 512:
        x[256:512] = 0.0
    if n >= 256:
        # amax 127 makes the scale exactly 1: x / 1 lands on .5 ties
        x[:8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    return x


def _payload(q, s):
    return np.concatenate([np.asarray(q).reshape(-1).view(np.uint8),
                           np.asarray(s, np.float32).view(np.uint8)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codec_plain_version_is_byte_identical(case, dtype):
    x32 = _codec_input(case)
    if dtype == "bfloat16":
        x32 = x32.astype(ml_dtypes.bfloat16).astype(np.float32)
        t = torch.from_numpy(x32).to(torch.bfloat16)
        jx = jnp.asarray(x32, jnp.bfloat16)
    else:
        t = torch.from_numpy(x32)
        jx = jnp.asarray(x32)
    q, s = quantize(t)
    host, meta = JaxInt8().encode(x32)
    got = _payload(q.numpy(), s.numpy())
    assert np.array_equal(got, host)
    jq, js = (np.asarray(a) for a in jax.device_get(
        pallas_quantize(jx, interpret=True)))
    ulps = np.abs(js.view(np.int32).astype(np.int64)
                  - s.numpy().view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    steps = np.abs(jq.astype(np.int32) - q.numpy().astype(np.int32))
    assert steps.max() <= 1
    assert not steps[ulps == 0].any()
    # the port's host codec is the reference's, byte for byte
    assert np.array_equal(Int8BlockCodec().encode(x32)[0], host)
    assert DeviceCodec.block_meta(x32.shape) == {
        k: meta[k] for k in ("shape", "pad", "blocks")}
    y = dequantize(q, s, x32.shape).numpy()
    assert np.array_equal(y.view(np.int32),
                          JaxInt8().decode(host, meta).view(np.int32))
    jy = pallas_dequantize(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                           x32.shape, interpret=True)
    assert np.array_equal(y.view(np.int32),
                          np.asarray(jax.device_get(jy)).view(np.int32))


def test_crc32_matches_reference():
    a = np.random.default_rng(0).standard_normal((33, 77)).astype(np.float32)
    assert crc32_array(a) == jax_crc32(a)
    assert crc32_array(a, chunk=100) == jax_crc32(a)


MODES = {"raw": dict(), "int8": dict(codec="int8"),
         "device_int8": dict(device_codec=True)}


def _reference_state():
    cfg = jax_get_config("granite-3-8b", tiny=True)
    return jax.device_get(jax_init_state(cfg, jax.random.PRNGKey(3)))


def _bits(x):
    a = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
    return a.dtype, a.shape, a.reshape(-1).view(np.uint8).tobytes()


def _assert_same(port_tree, ref_tree):
    p, r = flatten_named(port_tree), flatten_named(ref_tree)
    assert [n for n, _ in p] == [n for n, _ in r]
    for (name, a), (_, b) in zip(p, r):
        assert _bits(a) == _bits(b), name


def _manifest(d, step, crc=True):
    with open(os.path.join(d, f"step_{step:08d}", "manifest_h0.json")) as f:
        man = json.load(f)
    if not crc:
        for entry in man["arrays"].values():
            for sh in entry["shards"]:
                sh.pop("crc32")
    return man


@pytest.mark.parametrize("mode", sorted(MODES))
def test_checkpoints_cross_restore_bit_identically(tmp_path, mode):
    kw = dict(MODES[mode], fsync="none")
    ref_state = _reference_state()
    cfg = get_config("granite-3-8b", tiny=True)
    port_state = state_from_jax(cfg, ref_state, device="cpu")
    local = {"step": 7, "seed": 0, "rng": [1, 2]}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jm, tm = JaxManager(jdir, **kw), CheckpointManager(tdir, **kw)
    jm.save(7, jax.tree.map(jnp.asarray, ref_state), local)
    tm.save(7, port_state, local)
    jm.wait()
    tm.wait()

    # the two packages wrote the same checkpoint
    if mode == "device_int8":
        hdir = str(tmp_path / "jax_host")
        hm = JaxManager(hdir, codec="int8", fsync="none")
        hm.save(7, ref_state)
        hm.close()
        assert _manifest(hdir, 7) == _manifest(tdir, 7)
        assert _manifest(jdir, 7, crc=False) == _manifest(tdir, 7, crc=False)
    else:
        assert _manifest(jdir, 7) == _manifest(tdir, 7)
    assert sorted(os.listdir(os.path.join(jdir, "step_00000007"))) == \
        sorted(os.listdir(os.path.join(tdir, "step_00000007")))

    # each package restores the other's checkpoint with the bits the
    # writer's own package restores
    j_own, _ = JaxManager(jdir, **kw).restore(step=7)
    t_from_j, t_local = CheckpointManager(jdir, **kw).restore(
        step=7, like=port_state)
    j_from_t, j_local = JaxManager(tdir, **kw).restore(step=7)
    t_own, _ = CheckpointManager(tdir, **kw).restore(step=7, like=port_state)
    _assert_same(t_from_j, j_own)
    _assert_same(t_own, j_from_t)
    if mode == "device_int8":
        _assert_same(t_own, JaxManager(hdir, codec="int8").restore(step=7)[0])
    else:
        _assert_same(t_own, j_own)
    assert t_local == j_local == local
    if mode == "raw":
        _assert_same(t_own, ref_state)
    # a template-free restore rebuilds the same tree as CPU tensors
    t_free, _ = CheckpointManager(jdir, **kw).restore(step=7)
    _assert_same(t_free, j_own)
    for m in (jm, tm):
        m.close()


def test_restore_walks_back_past_a_corrupt_checkpoint(tmp_path):
    cfg = get_config("granite-3-8b", tiny=True)
    state = state_from_jax(cfg, _reference_state(), device="cpu")
    m = CheckpointManager(str(tmp_path), fsync="none", device_codec=True)
    m.save(2, state)
    m.save(4, state)
    victim = tmp_path / "step_00000004" / "params.embed.tok.s0_0.npy"
    raw = bytearray(victim.read_bytes())
    raw[-5] ^= 0x10
    victim.write_bytes(bytes(raw))
    got, _, step, skipped = m.restore_latest(like=state)
    assert step == 2 and skipped and skipped[0][0] == 4
    assert "CRC" in skipped[0][1]
    m.close()


def test_unsupported_paths_say_so(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP item 5"):
        CheckpointManager(str(tmp_path), delta=True)
    m = CheckpointManager(str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        m.restore(step=0, shardings=object())
    m.close()


def _policy_trace(mod_policy, mod_system, mode, formula):
    pol = mod_policy(mode=mode, every_n=3, formula=formula,
                     system=mod_system(node_mtbf_seconds=400.0, num_nodes=2,
                                       restart_seconds=5.0,
                                       downtime_seconds=2.0))
    rng = np.random.default_rng(11)
    out = []
    for step in range(1, 120):
        pol.observe_step(float(rng.uniform(0.05, 0.2)))
        if step % 17 == 0:
            pol.observe_recovery(restart_s=float(rng.uniform(1, 3)),
                                 downtime_s=float(rng.uniform(0.1, 1)))
        if mode == "risk_adjusted":
            pol.observe_risk(float(rng.uniform(0, 1)))
        due = pol.should_checkpoint(step)
        out.append((due, pol.interval_steps()))
        if due:
            pol.observe_checkpoint(float(rng.uniform(0.5, 2.0)))
            pol.record_checkpoint(step)
    return out


@pytest.mark.parametrize("mode", ["every_n", "young_daly", "risk_adjusted"])
@pytest.mark.parametrize("formula", ["paper", "standard"])
def test_policy_decisions_match_reference(mode, formula):
    assert _policy_trace(CheckpointPolicy, SystemModel, mode, formula) == \
        _policy_trace(JaxPolicy, JaxSystem, mode, formula)
