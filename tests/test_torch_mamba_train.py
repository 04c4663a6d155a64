"""Mamba-1 training in the port against the JAX package on the CPU.

The scan's plain backward (``kernels/selective_scan/ref.py:
selective_scan_bwd_ref``, an explicit reverse scan) is held to
``jax.vjp`` of the reference's ``models/mamba.py:_ssm_chunked`` (the
chunked scan the reference trains through), with S over two 128-step
chunks and a ragged S, h0 and the cotangent of h_last zero or not: every
gradient within 2e-5 of its largest magnitude.  Tiny falcon-mamba-7b
from one reference state (``state_from_jax``) and the reference
pipeline's batch: logits, the loss and every gradient leaf in float32
within 2e-5 (``rtol`` and ``atol``; 1.2e-6 of a leaf's largest
magnitude seen); in bfloat16 logits and loss within 2e-2 of the largest
magnitude and every gradient under ``tests/test_torch_train.py``'s
ratio rule (as close to the float32 reference as the reference's own
bfloat16 gradient, within 1.25x + 1e-3).  Then two whole steps, a
recovery run bit-equal to an uninterrupted one, the CLI, the train
layout, the train state's checkpoint crossing to the reference and
back, and the trained weights served."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CheckpointManager as JaxManager
from repro.data import make_pipeline as jax_make_pipeline
from repro.models import forward as jax_forward
from repro.models import get_config as jax_get_config
from repro.models.mamba import _ssm_chunked
from repro.train import init_state as jax_init_state
from repro.train import loss_fn as jax_loss_fn
from repro.train import make_train_step as jax_make_train_step
from repro_torch.core import (CheckpointManager, Dependability,
                              DependabilityConfig, FaultInjector,
                              run_with_recovery)
from repro_torch.data import make_pipeline
from repro_torch.kernels.selective_scan.ops import (SelectiveScanFunction,
                                                    selective_scan,
                                                    selective_scan_bwd)
from repro_torch.kernels.selective_scan.ref import (selective_scan_bwd_ref,
                                                    selective_scan_ref)
from repro_torch.launch import train as train_cli
from repro_torch.models import (forward, get_config, init_train_params,
                                params_from_jax, state_from_jax)
from repro_torch.train import init_state, loss_fn, make_train_step
from repro_torch.tree import flatten_named, leaves, unflatten

ARCH = "falcon-mamba-7b"
SEQ, BATCH = 16, 4
FP32_TOL = 2e-5
BF16_TOL = 2e-2
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype):
    jdt, tdt = DT[dtype]
    return (dataclasses.replace(jax_get_config(ARCH, tiny=True), dtype=jdt),
            dataclasses.replace(get_config(ARCH, tiny=True), dtype=tdt))


def _np(x):
    return np.asarray(jax.device_get(x)).astype(np.float32)


def _tbatch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _setup(dtype, seed=0):
    jcfg, tcfg = _configs(dtype)
    jstate = jax_init_state(jcfg, jax.random.PRNGKey(seed))
    tstate = state_from_jax(tcfg, jax.device_get(jstate), device="cpu")
    data = jax_make_pipeline(jcfg, SEQ, BATCH, seed=seed)
    batches = [jax.device_get(data.next_batch()) for _ in range(2)]
    return jcfg, tcfg, jstate, tstate, batches


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _scan_inputs(B, S, Di, N, seed):
    """tests/test_kernels.py's draws, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, Di)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, Di)))) * 0.1
          ).astype(np.float32)
    bm = rng.standard_normal((B, S, N)).astype(np.float32)
    cm = rng.standard_normal((B, S, N)).astype(np.float32)
    a = (-np.exp(rng.standard_normal((Di, N)) * 0.2)).astype(np.float32)
    h0 = (rng.standard_normal((B, Di, N)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((B, S, Di)).astype(np.float32)
    dh = rng.standard_normal((B, Di, N)).astype(np.float32)
    return x, dt, bm, cm, a, h0, dy, dh


def _assert_grad(got, want, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= FP32_TOL * scale, (
        what, np.abs(got - want).max() / scale)


@pytest.mark.parametrize("S", [256, 200, 1])
@pytest.mark.parametrize("carried", [False, True])
def test_scan_bwd_ref_matches_jax_grad_of_chunked_scan(S, carried):
    x, dt, bm, cm, a, h0, dy, dh = _scan_inputs(2, S, 8, 4, seed=S)
    if not carried:
        h0 = np.zeros_like(h0)
    _, vjp = jax.vjp(lambda dt_, x_, b_, c_, a_, h_: _ssm_chunked(
        dt_, x_, b_, c_, a_, h_), dt, x, bm, cm, a, h0)
    gdt, gx, gb, gc, ga, gh = vjp((dy, dh if carried else np.zeros_like(dh)))
    t = [torch.from_numpy(v) for v in (x, dt, bm, cm, a, h0, dy, dh)]
    got = selective_scan_bwd_ref(*t[:7], t[7] if carried else None)
    for name, g, w in zip(("dx", "ddt", "dB", "dC", "dA", "dh0"), got,
                          (gx, gdt, gb, gc, ga, gh)):
        _assert_grad(g, w, f"{name} S={S}")


def test_scan_function_is_autograd_of_the_plain_scan():
    """The explicit reverse scan is the gradient autograd takes through
    the plain forward; ``selective_scan`` records the Function when a
    gradient is wanted and runs the plain scan otherwise; B and C as
    column slices of one tensor (as ``ssm_apply`` passes them)."""
    x, dt, bm, cm, a, h0, dy, dh = (torch.from_numpy(v) for v in
                                    _scan_inputs(2, 40, 6, 3, seed=1))
    bc = torch.cat([bm, cm], dim=-1)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, bc, a, h0)]
    y, h = selective_scan(ins[0], ins[1], ins[2][..., :3], ins[2][..., 3:],
                          ins[3], ins[4])
    assert type(y.grad_fn).__name__ == \
        SelectiveScanFunction.__name__ + "Backward"
    fn_grads = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), ins)
    ref_ins = [t.clone().requires_grad_(True) for t in (x, dt, bc, a, h0)]
    y2, h2 = selective_scan_ref(ref_ins[0], ref_ins[1], ref_ins[2][..., :3],
                                ref_ins[2][..., 3:], ref_ins[3], ref_ins[4])
    auto = torch.autograd.grad((y2 * dy).sum() + (h2 * dh).sum(), ref_ins)
    assert torch.equal(y.detach(), y2.detach())
    for g, w in zip(fn_grads, auto):
        _assert_grad(g, w.numpy(), "autograd")
    with torch.no_grad():
        y3, _ = selective_scan(*ins[:2], ins[2][..., :3], ins[2][..., 3:],
                               *ins[3:])
    assert y3.grad_fn is None and torch.equal(y3, y2.detach())
    # an unused h_last: its gradient is zero
    g_only_y = selective_scan_bwd(x, dt, bm, cm, a, h0, dy)
    g_zero = selective_scan_bwd(x, dt, bm, cm, a, h0, dy,
                                torch.zeros_like(dh))
    for p, q in zip(g_only_y, g_zero):
        assert torch.equal(p, q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_falcon_mamba_loss_and_every_grad_match_reference(dtype):
    jcfg, tcfg, jstate, tstate, batches = _setup(dtype)
    batch = batches[0]
    jlogits = _np(jax_forward(jcfg, jstate["params"], batch,
                              mode="train")[0])
    tlogits, _ = forward(tcfg, tstate["params"], _tbatch(batch),
                         mode="train")
    tlogits = tlogits.detach().float().numpy()

    def jax_grads(cfg):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jax_loss_fn(cfg, p, batch), has_aux=True)(
                jstate["params"])
        return float(loss), dict(flatten_named(jax.device_get(grads)))

    jloss, jnamed = jax_grads(jcfg)
    live = [p.detach().requires_grad_(True)
            for p in leaves(tstate["params"])]
    tloss, _ = loss_fn(tcfg, unflatten(tstate["params"], live),
                       _tbatch(batch))
    tgrads = torch.autograd.grad(tloss, live)
    names = [n for n, _ in flatten_named(tstate["params"])]
    assert sorted(jnamed) == sorted(names)
    assert any(".ssm.A_log" in n for n in names)
    if dtype == "float32":
        np.testing.assert_allclose(tlogits, jlogits, rtol=FP32_TOL,
                                   atol=FP32_TOL)
        assert abs(float(tloss.detach()) - jloss) <= FP32_TOL * abs(jloss)
        for name, g in zip(names, tgrads):
            assert g.dtype == torch.float32, name
            np.testing.assert_allclose(g.numpy(), _np(jnamed[name]),
                                       rtol=FP32_TOL, atol=FP32_TOL,
                                       err_msg=name)
        return
    scale = np.abs(jlogits).max()
    assert np.abs(tlogits - jlogits).max() <= BF16_TOL * scale
    assert abs(float(tloss.detach()) - jloss) <= BF16_TOL * abs(jloss)
    _, j32 = jax_grads(_configs("float32")[0])
    for name, g in zip(names, tgrads):
        got, ref16, truth = (g.float().numpy(), _np(jnamed[name]),
                             _np(j32[name]))
        err, ref_err = _rel(got, truth), _rel(ref16, truth)
        assert err <= 1.25 * ref_err + 1e-3, (name, err, ref_err)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """Two whole float32 steps: metrics and every state leaf."""
    jcfg, tcfg, jstate, tstate, batches = _setup("float32")
    kw = dict(total_steps=20, warmup_steps=1, microbatches=microbatches)
    jstep = jax.jit(jax_make_train_step(jcfg, **kw))
    tstep = make_train_step(tcfg, **kw)
    for batch in batches:
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        for k in ("loss", "grad_norm", "nll"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
    jflat = dict(flatten_named(jax.device_get(jstate)))
    for name, leaf in flatten_named(tstate):
        want = np.asarray(jflat[name])
        assert leaf.numpy().dtype == want.dtype, name
        if name in ("step", "opt.count", "rng"):
            assert np.array_equal(leaf.numpy(), want), name
        else:
            np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-4,
                                       atol=1e-4, err_msg=name)


def test_train_layout_matches_reference():
    """``init_train_params`` builds the reference's stacked SSM blocks:
    the same leaves, shapes and dtypes (A_log and D float32 masters like
    every leaf; the numbers come from another generator), A_log and D
    at the reference's values."""
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _configs(dtype)
        jflat = flatten_named(jax.device_get(
            jax_init_state(jcfg, jax.random.PRNGKey(0))))
        tflat = flatten_named(init_state(tcfg, seed=0, device="cpu"))
        assert [n for n, _ in jflat] == [n for n, _ in tflat]
        for (n, j), (_, t) in zip(jflat, tflat):
            j = np.asarray(j)
            assert tuple(t.shape) == j.shape and t.numpy().dtype == j.dtype, n
            if n.endswith((".A_log", ".D", ".dt_b", ".conv_b")):
                np.testing.assert_array_equal(t.numpy(), j, err_msg=n)


def _dep(path, **kw):
    return Dependability(DependabilityConfig(
        checkpoint_dir=str(path), policy_mode="every_n", every_n=2,
        heartbeat=False, signal_detection=False, fsync="none",
        **kw)).start()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recovered_run_is_bit_equal(tmp_path, dtype):
    """A fail-stop at step 4 with async saves every 2: the recovered run
    ends bit for bit where the uninterrupted run ends."""
    steps = 6
    _, tcfg = _configs(dtype)
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


def test_cli_trains_falcon_mamba(tmp_path, capsys):
    assert train_cli.main([
        "--arch", ARCH, "--tiny", "--device", "cpu", "--steps", "6",
        "--seq-len", "16", "--global-batch", "4", "--microbatches", "2",
        "--policy", "every_n", "--every-n", "2", "--async-save",
        "--inject-failure", "4", "--ckpt-dir", str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    assert "[train] done" in out and "restarts=1" in out
    # a rank mesh trains them too (train/mesh_step.py)
    assert train_cli.main(["--arch", ARCH, "--tiny", "--device", "cpu",
                           "--data-par", "2", "--steps", "2",
                           "--seq-len", "16", "--global-batch", "4",
                           "--ckpt-dir", str(tmp_path / "ck2")]) == 0


def test_train_state_checkpoint_crosses_both_ways(tmp_path):
    """The port's SSM train state saved by the port restores in the
    reference with the same bits, and the reference's save restores in
    the port."""
    jcfg, tcfg = _configs("bfloat16")
    state = init_state(tcfg, seed=5, device="cpu")
    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    tm = CheckpointManager(tdir, fsync="none")
    tm.save(3, state, {"step": 3})
    tm.close()
    j_state, _ = JaxManager(tdir, fsync="none").restore(step=3)
    jflat = dict(flatten_named(j_state))
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


def test_trained_weights_serve():
    """``params_from_jax`` takes the port's train parameters too: a
    prefill of the serving weights gives the train-mode logits."""
    _, tcfg = _configs("float32")
    params = init_train_params(tcfg, seed=2, device="cpu")
    serve = params_from_jax(tcfg, params, device="cpu")
    assert serve["layers"][0]["ssm"]["A_log"].dtype == torch.float32
    tokens = torch.randint(0, tcfg.vocab_size, (2, SEQ),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        train_logits, _ = forward(tcfg, params, {"tokens": tokens},
                                  mode="train")
        logits, _ = forward(tcfg, serve, {"tokens": tokens}, mode="prefill")
    np.testing.assert_allclose(logits.numpy(), train_logits.numpy(),
                               rtol=1e-5, atol=1e-5)
