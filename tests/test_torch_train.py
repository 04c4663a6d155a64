"""The port's train step against the JAX package's on the CPU.

Both packages start from one train state (the reference's ``init_state``
carried over by ``state_from_jax``) and see the same batches (the
reference pipeline's, as numpy).  Train-mode logits, the loss, every
gradient leaf, the global grad norm and whole steps (clip, AdamW, the
step counter and the rng key) are compared.  In float32 every tensor is
held elementwise to 1e-4 (XLA and PyTorch sum in different orders).  In
bfloat16 the two frameworks round at different places (see
tests/test_torch_model.py): logits, loss and the step's metrics and
parameters are held to 2e-2 of each tensor's largest magnitude; a
gradient (and the AdamW moments made from it: m, and sqrt(v), which is
in the gradient's units) carries the bfloat16 rounding of every layer it
passed back through, so it is held to the float32 reference instead: its
relative L2 error must be no more than 1.25x the reference's own
bfloat16 error (+1e-3) — the port in bfloat16 is as accurate as the
reference in bfloat16.  The configs are tiny
granite-3-8b and tiny gemma2-27b, which adds LOCAL attention with a
window shorter than the sequence, both softcaps, sandwich norms, GeGLU
and the embedding scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_pipeline as jax_make_pipeline
from repro.models import forward as jax_forward
from repro.models import get_config as jax_get_config
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim.schedule import cosine_schedule as jax_cosine
from repro.train import init_state as jax_init_state
from repro.train import loss_fn as jax_loss_fn
from repro.train import make_train_step as jax_make_train_step
from repro_torch.data import ShardedPipeline, make_pipeline
from repro_torch.models import forward, get_config, state_from_jax
from repro_torch.optim import adamw_update, clip_by_global_norm
from repro_torch.optim import cosine_schedule
from repro_torch.train import init_state, loss_fn, make_train_step
from repro_torch.tree import flatten_named, leaves, unflatten

ARCHS = ("granite-3-8b", "gemma2-27b")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SEQ, BATCH = 16, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, dtype):
    jdt, tdt = DT[dtype]
    jcfg = dataclasses.replace(jax_get_config(arch, tiny=True), dtype=jdt)
    tcfg = dataclasses.replace(get_config(arch, tiny=True), dtype=tdt)
    return jcfg, tcfg


def _np(x):
    return np.asarray(jax.device_get(x)).astype(np.float32)


def _close(t, j, tol, what=""):
    want = _np(j)
    got = t.detach().float().numpy()
    # bfloat16: the absolute tolerance follows the tensor's scale
    atol = tol * max(1e-30, float(np.abs(want).max())) if tol > 1e-3 else tol
    np.testing.assert_allclose(got, want, atol=atol, rtol=tol, err_msg=what)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _as_accurate(t, j16, j32, what="", fn=lambda a: a):
    """The port's bfloat16 result is as close to the float32 reference as
    the reference's bfloat16 result is (compared through ``fn``)."""
    got, ref, truth = (fn(np.asarray(x, np.float32)) for x in
                       (t.detach().float().numpy(), _np(j16), _np(j32)))
    err, ref_err = _rel(got, truth), _rel(ref, truth)
    assert err <= 1.25 * ref_err + 1e-3, (what, err, ref_err)


def _setup(arch, dtype, seed=0):
    jcfg, tcfg = _configs(arch, dtype)
    jstate = jax_init_state(jcfg, jax.random.PRNGKey(seed))
    tstate = state_from_jax(tcfg, jax.device_get(jstate), device="cpu")
    data = jax_make_pipeline(jcfg, SEQ, BATCH, seed=seed)
    batches = [jax.device_get(data.next_batch()) for _ in range(2)]
    return jcfg, tcfg, jstate, tstate, batches


def _tbatch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_loss_and_grads_match_reference(arch, dtype):
    jcfg, tcfg, jstate, tstate, batches = _setup(arch, dtype)
    tol = TOL[dtype]
    batch = batches[0]
    jlogits = jax_forward(jcfg, jstate["params"], batch, mode="train")[0]
    tlogits, _ = forward(tcfg, tstate["params"], _tbatch(batch), mode="train")
    _close(tlogits, jlogits, tol, "logits")

    def jax_grads(cfg):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jax_loss_fn(cfg, p, batch), has_aux=True)(
                jstate["params"])
        return loss, dict(flatten_named(jax.device_get(grads)))

    jloss, jnamed = jax_grads(jcfg)
    live = [p.detach().requires_grad_(True)
            for p in leaves(tstate["params"])]
    tloss, _ = loss_fn(tcfg, unflatten(tstate["params"], live),
                       _tbatch(batch))
    tgrads = torch.autograd.grad(tloss, live)
    _close(tloss, jloss, tol, "loss")
    names = [n for n, _ in flatten_named(tstate["params"])]
    assert sorted(jnamed) == sorted(names)
    if dtype == "float32":
        for name, g in zip(names, tgrads):
            _close(g, jnamed[name], tol, f"grad {name}")
    else:
        _, j32 = jax_grads(_configs(arch, "float32")[0])
        for name, g in zip(names, tgrads):
            _as_accurate(g, jnamed[name], j32[name], f"grad {name}")


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, dtype, microbatches):
    """Two whole steps: metrics, params, moments, count, step, rng."""
    jcfg, tcfg, jstate, tstate, batches = _setup(arch, dtype)
    tol = TOL[dtype]
    kw = dict(total_steps=20, warmup_steps=1, microbatches=microbatches)
    jstep = jax.jit(jax_make_train_step(jcfg, **kw))
    tstep = make_train_step(tcfg, **kw)
    j32_step = jax.jit(jax_make_train_step(_configs(arch, "float32")[0],
                                           **kw))
    j32_state = jstate
    for batch in batches:
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        j32_state, _ = j32_step(j32_state, batch)
        for k in ("loss", "grad_norm", "lr", "nonfinite", "nll"):
            _close(tm[k], jm[k], tol, k)
    jflat = dict(flatten_named(jax.device_get(jstate)))
    j32 = dict(flatten_named(jax.device_get(j32_state)))
    for name, leaf in flatten_named(tstate):
        want = jflat[name]
        if name in ("step", "opt.count", "rng"):
            assert np.array_equal(leaf.numpy(), np.asarray(want)), name
            assert leaf.numpy().dtype == np.asarray(want).dtype, name
        elif dtype == "bfloat16" and name.startswith("opt.m."):
            _as_accurate(leaf, want, j32[name], name)
        elif dtype == "bfloat16" and name.startswith("opt.v."):
            _as_accurate(leaf, want, j32[name], name, fn=np.sqrt)
        else:
            _close(leaf, want, tol, name)


def test_optimizer_pieces_match_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 2)}}

    def tree(scale):
        def make(s):
            if isinstance(s, dict):
                return {k: make(v) for k, v in s.items()}
            return (rng.standard_normal(s) * scale).astype(np.float32)
        return make(shapes)

    params, grads = tree(1.0), tree(3.0)
    tp = unflatten(params, [torch.from_numpy(a) for a in leaves(params)])
    tg = unflatten(grads, [torch.from_numpy(a) for a in leaves(grads)])
    jc, jn = jax_clip(grads, 1.0)
    tc, tn = clip_by_global_norm(tg, 1.0)
    _close(tn, jn, 1e-6, "norm")
    for a, b in zip(leaves(tc), leaves(jax.device_get(jc))):
        _close(a, b, 1e-6)
    jopt = jax_adamw_init(params)
    jopt = {"m": jax.tree.map(lambda x: x + 0.01, jopt["m"]),
            "v": jax.tree.map(lambda x: x + 0.02, jopt["v"]),
            "count": jnp.asarray(3, jnp.int32)}
    topt = {"m": unflatten(params, [torch.from_numpy(np.array(a))
                                    for a in leaves(jopt["m"])]),
            "v": unflatten(params, [torch.from_numpy(np.array(a))
                                    for a in leaves(jopt["v"])]),
            "count": torch.tensor(3, dtype=torch.int32)}
    jp, jo = jax_adamw_update(grads, jopt, params, lr=1e-2)
    tp2, to = adamw_update(tg, topt, tp, lr=1e-2)
    for a, b in zip(leaves(tp2) + leaves(to["m"]) + leaves(to["v"]),
                    leaves(jax.device_get(jp)) + leaves(jo["m"])
                    + leaves(jo["v"])):
        _close(a, b, 1e-6)
    assert int(to["count"]) == int(jo["count"]) == 4
    jlr, tlr = jax_cosine(3e-4, 10, 100), cosine_schedule(3e-4, 10, 100)
    for s in (0, 5, 10, 50, 100, 150):
        _close(tlr(torch.tensor(s, dtype=torch.int32)),
               jlr(jnp.asarray(s, jnp.int32)), 1e-6, f"lr {s}")


def test_init_state_layout_matches_reference():
    """The port's fresh state has the reference's leaves, shapes and
    dtypes (the numbers come from another generator)."""
    for arch in ARCHS:
        jcfg, tcfg = _configs(arch, "bfloat16")
        jflat = flatten_named(jax.device_get(
            jax_init_state(jcfg, jax.random.PRNGKey(0))))
        tflat = flatten_named(init_state(tcfg, seed=0, device="cpu"))
        assert [n for n, _ in jflat] == [n for n, _ in tflat]
        for (n, j), (_, t) in zip(jflat, tflat):
            j = np.asarray(j)
            assert tuple(t.shape) == j.shape, n
            assert t.numpy().dtype == j.dtype, n
        assert tflat[-2][0] == "rng"
        assert tflat[-2][1].tolist() == np.asarray(jflat[-2][1]).tolist()


def test_pipeline_state_matches_reference():
    """The local-state records are the reference's exactly (the shard
    keys are threefry's), and slice mode is width-independent."""
    from repro.data.pipeline import ShardedPipeline as JaxSharded

    jcfg, tcfg = _configs("granite-3-8b", "float32")
    for mode in ("fold", "slice"):
        for host, hosts in ((0, 1), (1, 3)):
            kw = dict(seed=7, host_id=host, num_hosts=hosts,
                      shard_mode=mode)
            jd = jax_make_pipeline(jcfg, SEQ, 6, **kw)
            td = make_pipeline(tcfg, SEQ, 6, **kw)
            for _ in range(3):
                jb, tb = jd.next_batch(), td.next_batch()
                assert tuple(tb["tokens"].shape) == jb["tokens"].shape
            assert td.state_dict() == jd.state_dict()
            td.load_state_dict(jd.state_dict())
            assert td.step == 3
    jp, tp = JaxSharded(jcfg, SEQ, 6, dp_width=3, seed=5), \
        ShardedPipeline(tcfg, SEQ, 6, dp_width=3, seed=5)
    wide = [tp.next_batch()["tokens"] for _ in range(2)]
    [jp.next_batch() for _ in range(2)]
    assert tp.shard_state_dicts() == jp.shard_state_dicts()
    saved = tp.shard_state_dicts()
    jp.repartition(2)
    tp.repartition(2)
    assert tp.shard_state_dicts() == jp.shard_state_dicts()
    narrow = ShardedPipeline(tcfg, SEQ, 6, dp_width=1, seed=5)
    narrow.load_shard_state_dicts(saved)
    assert narrow.remapped_from == 3 and narrow.step == 2
    fresh = ShardedPipeline(tcfg, SEQ, 6, dp_width=2, seed=5)
    assert torch.equal(fresh.next_batch()["tokens"], wide[0])
