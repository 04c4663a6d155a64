"""The new families' train steps, train state, pipeline and checkpoints in
the port against the JAX package on the CPU (one torch thread).

Two whole float32 steps from one reference state on the reference's
batches (1 and 2 microbatches; qwen2-vl's M-RoPE positions split along
their batch axis): the metrics and every state leaf within 1e-4, the
step counter, AdamW's count and the rng key equal (bfloat16 gradients:
``test_torch_families_train.py``).  The fresh train state has the
reference's leaves, shapes and dtypes (tiny recurrentgemma unstacked as
``layers.layer_<i>``, a 6-layer variant and recurrentgemma-2b's 26 layers
stacked as blocks, padded heads padded, no ``embed`` for embedding
inputs).  The pipeline draws the reference's keys and shapes and keeps
its local-state records; shards slice ``positions`` on axis 1.  Then
the CLI, a recovered run bit-equal to an uninterrupted one, the unstacked
state's checkpoint crossing to the reference and back, and the trained
weights served."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CheckpointManager as JaxManager
from repro.data import make_pipeline as jax_make_pipeline
from repro.data.pipeline import ShardedPipeline as JaxSharded
from repro.models import get_config as jax_get_config
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.core import (CheckpointManager, Dependability,
                              DependabilityConfig, FaultInjector,
                              run_with_recovery)
from repro_torch.data import ShardedPipeline, make_pipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import (forward, get_config, init_train_params,
                                params_from_jax)
from repro_torch.train import init_state, make_train_step
from repro_torch.train.step import split_microbatches
from repro_torch.tree import flatten_named
from torch_family_cases import (BATCH, NEW, SEQ, VARIANT_IDS, VARIANTS,
                                configs, mrope_ids, setup)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch,extra", VARIANTS, ids=VARIANT_IDS)
def test_train_step_matches_reference(arch, extra, microbatches):
    """Two whole float32 steps: metrics, params, moments, count, step,
    rng."""
    jcfg, tcfg, jstate, tstate, batches = setup(arch, "float32", extra)
    kw = dict(total_steps=20, warmup_steps=1, microbatches=microbatches)
    jstep = jax.jit(jax_make_train_step(jcfg, **kw))
    tstep = make_train_step(tcfg, **kw)
    for batch in batches:
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        for k in ("loss", "grad_norm", "lr", "nonfinite", "nll", "aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    jflat = dict(flatten_named(jax.device_get(jstate)))
    assert sorted(jflat) == sorted(n for n, _ in flatten_named(tstate))
    for name, leaf in flatten_named(tstate):
        want = np.asarray(jflat[name])
        assert leaf.numpy().dtype == want.dtype, name
        if name in ("step", "opt.count", "rng"):
            assert np.array_equal(leaf.numpy(), want), name
        else:
            np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-4,
                                       atol=1e-4, err_msg=name)


def test_microbatches_split_positions_on_their_batch_axis():
    pos = torch.from_numpy(mrope_ids(4, 4, 3, 3))
    batch = {"embeddings": torch.zeros(4, 16, 8), "targets":
             torch.arange(64).reshape(4, 16), "positions": pos}
    parts = split_microbatches(batch, 2)
    assert [tuple(p["positions"].shape) for p in parts] == [(3, 2, 16)] * 2
    assert torch.equal(parts[1]["positions"], pos[:, 2:])
    assert torch.equal(parts[1]["targets"], batch["targets"][2:])
    with pytest.raises(ValueError, match="not divisible"):
        split_microbatches(batch, 3)


LAYOUTS = VARIANTS + [
    ("recurrentgemma-2b", (("pad_heads_to", 8),)),
    ("qwen2-vl-2b", (("pad_heads_to", 8),))]


@pytest.mark.parametrize("arch,extra", LAYOUTS)
def test_init_state_layout_matches_reference(arch, extra):
    """The port's fresh state has the reference's leaves, shapes and
    dtypes (the numbers come from another generator; ``lam``'s are the
    reference's)."""
    jcfg, tcfg = configs(arch, "bfloat16", extra)
    jflat = flatten_named(jax.device_get(
        jax_init_state(jcfg, jax.random.PRNGKey(0))))
    tflat = flatten_named(init_state(tcfg, seed=0, device="cpu"))
    assert [n for n, _ in jflat] == [n for n, _ in tflat]
    for (n, j), (_, t) in zip(jflat, tflat):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape and t.numpy().dtype == j.dtype, n
        if n.endswith(".lam"):
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, err_msg=n)
    names = [n for n, _ in tflat]
    assert any(".embed." in n for n in names) != tcfg.embedding_inputs
    if arch == "recurrentgemma-2b" and not extra:
        assert "params.layers.layer_4.rec.lam" in names


def test_full_recurrentgemma_stacks_two_blocks():
    """recurrentgemma-2b's 26 layers over its 13-layer pattern: two
    stacked blocks, the reference's shapes (on the meta device)."""
    full = jax_get_config("recurrentgemma-2b")
    tflat = dict(flatten_named(init_train_params(
        get_config("recurrentgemma-2b"), seed=0, device="meta")))
    jflat = dict(flatten_named(jax.eval_shape(
        lambda: jax_init_state(full, jax.random.PRNGKey(0))["params"])))
    assert sorted(tflat) == sorted(jflat)
    for n, t in tflat.items():
        assert tuple(t.shape) == jflat[n].shape, n
    assert tflat["blocks.l12.rec.lam"].shape == (2, 2560)
    assert tflat["blocks.l2.attn.wq"].shape == (2, 2560, 16, 256)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "hubert-xlarge",
                                  "recurrentgemma-2b"])
def test_pipeline_matches_reference(arch):
    """The reference's keys, shapes and dtypes (embeddings in the compute
    dtype, text M-RoPE ids), its local-state records, slice-mode shards
    cutting ``positions`` on axis 1, and a width-independent merge."""
    jcfg, tcfg = configs(arch, "bfloat16")
    for mode in ("fold", "slice"):
        kw = dict(seed=7, host_id=1, num_hosts=2, shard_mode=mode)
        jd = jax_make_pipeline(jcfg, SEQ, 6, **kw)
        td = make_pipeline(tcfg, SEQ, 6, **kw)
        jb, tb = jd.next_batch(), td.next_batch()
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert tuple(tb[k].shape) == jb[k].shape, (mode, k)
            assert str(tb[k].dtype).split(".")[-1] == str(jb[k].dtype), k
        assert td.state_dict() == jd.state_dict()
    if "embeddings" in tb:
        assert 0.005 < float(tb["embeddings"].float().std()) < 0.05
    if "positions" in tb:
        assert torch.equal(tb["positions"][1, 0].long(), torch.arange(SEQ))
    jp, tp = (JaxSharded(jcfg, SEQ, 6, dp_width=3, seed=5),
              ShardedPipeline(tcfg, SEQ, 6, dp_width=3, seed=5))
    step = tp.step
    merged = tp.next_batch()
    jp.next_batch()
    assert tp.shard_state_dicts() == jp.shard_state_dicts()
    shards = [s.peek_batch(step) for s in tp.shards]
    for k, v in merged.items():
        axis = 1 if k == "positions" else 0
        assert sum(s[k].shape[axis] for s in shards) == 6
        assert torch.equal(torch.cat([s[k] for s in shards], dim=axis), v)
    narrow = ShardedPipeline(tcfg, SEQ, 6, dp_width=1, seed=5)
    narrow.load_shard_state_dicts(tp.shard_state_dicts())
    wide = ShardedPipeline(tcfg, SEQ, 6, dp_width=2, seed=5)
    wide.load_shard_state_dicts(tp.shard_state_dicts())
    a, b = narrow.next_batch(), wide.next_batch()
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen2-vl-2b"])
def test_cli_trains_new_families(tmp_path, capsys, arch):
    assert train_cli.main([
        "--arch", arch, "--tiny", "--device", "cpu", "--steps", "6",
        "--seq-len", "16", "--global-batch", "4", "--microbatches", "2",
        "--policy", "every_n", "--every-n", "2", "--async-save",
        "--inject-failure", "4", "--ckpt-dir", str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    assert "[train] done" in out and "restarts=1" in out
    # a rank mesh trains them too (train/mesh_step.py)
    assert train_cli.main(["--arch", arch, "--tiny", "--device", "cpu",
                           "--data-par", "2", "--steps", "2",
                           "--seq-len", "16", "--global-batch", "4",
                           "--ckpt-dir", str(tmp_path / "ck2")]) == 0


def _dep(path, **kw):
    return Dependability(DependabilityConfig(
        checkpoint_dir=str(path), policy_mode="every_n", every_n=2,
        heartbeat=False, signal_detection=False, fsync="none",
        **kw)).start()


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen2-vl-2b"])
def test_recovered_run_is_bit_equal(tmp_path, arch):
    """A fail-stop at step 4 with async raw saves every 2: the recovered
    run ends bit for bit where the uninterrupted run ends."""
    steps = 6
    _, tcfg = configs(arch, "float32")
    step_fn = make_train_step(tcfg, total_steps=steps, warmup_steps=1,
                              microbatches=2)
    state = init_state(tcfg, seed=3, device="cpu")
    data = make_pipeline(tcfg, SEQ, BATCH, seed=3)
    ref_state = state
    for _ in range(steps):
        ref_state, _ = step_fn(ref_state, data.next_batch())
    data = make_pipeline(tcfg, SEQ, BATCH, seed=3)
    dep = _dep(tmp_path, async_save=True)
    dep.register_local_state(data)
    injector = FaultInjector()
    injector.schedule_failstop(4)
    try:
        out, info = run_with_recovery(dep, step_fn, state, data, steps,
                                      fault_injector=injector, like=state)
    finally:
        dep.stop()
    assert info["status"] == "done" and info["restarts"] == 1
    for (n, a), (_, b) in zip(flatten_named(out), flatten_named(ref_state)):
        assert a.dtype == b.dtype and torch.equal(a, b), n


def test_unstacked_checkpoint_crosses_both_ways(tmp_path):
    """Tiny recurrentgemma's unstacked train state saved raw by the port
    restores in the reference under the reference's names
    (``params.layers.layer_<i>...``) with the same bits, and the
    reference's save restores in the port."""
    _, tcfg = configs("recurrentgemma-2b", "bfloat16")
    state = init_state(tcfg, seed=5, device="cpu")
    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    tm = CheckpointManager(tdir, fsync="none")
    tm.save(3, state, {"step": 3})
    tm.close()
    j_state, _ = JaxManager(tdir, fsync="none").restore(step=3)
    jflat = dict(flatten_named(j_state))
    names = [n for n, _ in flatten_named(state)]
    assert sorted(jflat) == sorted(names)
    assert "params.layers.layer_2.attn.wq" in jflat
    assert "opt.m.layers.layer_4.rec.lam" in jflat
    for n, t in flatten_named(state):
        assert np.array_equal(t.numpy(), np.asarray(jflat[n])), n
    jm = JaxManager(jdir, fsync="none")
    jm.save(3, jax.tree.map(jnp.asarray, j_state), {"step": 3})
    jm.close()
    back, local = CheckpointManager(jdir, fsync="none").restore(
        step=3, like=state)
    assert local == {"step": 3}
    for (n, a), (_, b) in zip(flatten_named(back), flatten_named(state)):
        assert a.dtype == b.dtype and torch.equal(a, b), n


@pytest.mark.parametrize("arch", NEW)
def test_trained_weights_serve(arch):
    """``params_from_jax`` takes the port's train parameters of every new
    family: a prefill of the serving weights gives the train-mode
    logits."""
    _, tcfg = configs(arch, "float32")
    params = init_train_params(tcfg, seed=2, device="cpu")
    serve = params_from_jax(tcfg, params, device="cpu")
    batch = {k: v for k, v in make_pipeline(tcfg, SEQ, 2, seed=4)
             .next_batch().items() if k != "targets"}
    if tcfg.mrope_sections:
        batch["positions"] = torch.from_numpy(mrope_ids(2, 4, 3, 3))
    with torch.no_grad():
        train_logits, _ = forward(tcfg, params, batch, mode="train")
        logits, _ = forward(tcfg, serve, batch, mode="prefill")
    np.testing.assert_allclose(logits.numpy(), train_logits.numpy(),
                               rtol=1e-5, atol=1e-5)
    if tcfg.embedding_inputs:
        assert "embed" not in params
