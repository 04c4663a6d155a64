"""The rest of the port's serving slice on the CPU, against the JAX
package: attention rows in the slot pool, lockstep decode and warm
standbys.

Tiny granite and tiny gemma2 (LOCAL layers with a window of 8, so a
longer cache rolls) in float32 on both sides, one set of weights
(``params_from_jax``), prompts from a numpy seed:

- (a) ``make_prefill_step`` + ``make_decode_step`` over a lockstep
  ``init_cache(cfg, 3, L)``: logits within 1e-4 of the largest logit of
  the reference's, greedy tokens equal;
- (b) ``ServeEngine(paged=False)`` streams equal the JAX engine's
  ``paged=False`` streams;
- (c) the port's paged streams equal its slot streams, in two arrival
  orders (the contract of tests/test_paged.py);
- (d) a replica kill on the slot pool drops nothing and the retried
  streams are token-identical;
- (e) a warm standby restored by the port from checkpoints that
  ``repro.core.CheckpointManager`` wrote, past a corrupt newest one,
  takes over the killed replica (tests/test_serve.py's
  ``test_e2e_warm_standby_restores_capacity``);
- (f) the CLI with ``--legacy-pool --standbys 1``;
- (g) an idle slot decoded past ``cache_len`` neither raises nor changes
  an active row's tokens.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CheckpointManager as JaxManager
from repro.models import forward as jax_forward
from repro.models import get_config as jax_get_config
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.serve import ServeEngine as JaxServeEngine
from repro.train import make_decode_step as jax_make_decode_step
from repro.train import make_prefill_step as jax_make_prefill_step
from repro_torch.core import CheckpointManager, FaultInjector
from repro_torch.models import (forward, get_config, init_cache,
                                init_params, params_from_jax)
from repro_torch.serve import CachePool, ServeEngine, make_standby_source
from repro_torch.train import (make_decode_step, make_prefill_step,
                               make_serve_decode_step)
from repro_torch.tree import flatten_named

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("granite-3-8b", "gemma2-27b")
MAX_LEN = 32
GEN = 6
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers beside
    timing-sensitive multi-process tests, and idle OpenMP threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch):
    jcfg = dataclasses.replace(jax_get_config(arch, tiny=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(arch, tiny=True),
                               dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = _configs(request.param)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(jax.device_get(x)), jparams)
    return jcfg, tcfg, jparams, params_from_jax(tcfg, tree, device="cpu")


@pytest.fixture(scope="module")
def granite():
    jcfg, tcfg = _configs("granite-3-8b")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(jax.device_get(x)), jparams)
    return tcfg, params_from_jax(tcfg, tree, device="cpu")


def _prompts(vocab, n=6, seed=23):
    """``n`` prompts of 5-15 tokens (past gemma2's window of 8)."""
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, int(k))]
            for k in rng.integers(5, 16, n)]


def _run(engine, prompts, gen=GEN):
    rids = [engine.submit(p, gen) for p in prompts]
    try:
        results = engine.run()
    finally:
        engine.shutdown()
    return [results[r] for r in rids]


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy()
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= tol * scale


# ---------------------------------------------------------------------------
# (a) lockstep decode over a B-row cache
# ---------------------------------------------------------------------------

def test_lockstep_decode_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    B, P, L, steps = 3, 10, 20, 8            # L > gemma2's window of 8
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (B, P)).astype(np.int32)

    # logits, each side fed the reference's greedy tokens
    jl, jc, _ = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                            mode="prefill",
                            cache=jax_init_cache(jcfg, B, L))
    with torch.no_grad():
        tl, tc = forward(tcfg, tparams,
                         {"tokens": torch.from_numpy(toks).long()},
                         mode="prefill", cache=init_cache(tcfg, B, L, "cpu"))
    _close(tl, jl)
    assert tc["index"].tolist() == [P] * B
    for _ in range(steps):
        nxt = np.argmax(np.asarray(jl)[:, -1, :jcfg.vocab_size],
                        -1).astype(np.int32)[:, None]
        jl, jc, _ = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(nxt)},
                                mode="decode", cache=jc)
        with torch.no_grad():
            tl, tc = forward(tcfg, tparams,
                             {"tokens": torch.from_numpy(nxt).long()},
                             mode="decode", cache=tc)
        _close(tl, jl)
    assert tc["index"].tolist() == [P + steps] * B

    # greedy streams through the step functions
    jpre = jax.jit(jax_make_prefill_step(jcfg))
    jdec = jax.jit(jax_make_decode_step(jcfg))
    tok, cache = jpre(jparams, {"tokens": jnp.asarray(toks)},
                      jax_init_cache(jcfg, B, L))
    want = [np.asarray(tok)]
    for _ in range(steps):
        tok, cache = jdec(jparams, {"tokens": tok[:, None]}, cache)
        want.append(np.asarray(tok))
    pre, dec = make_prefill_step(tcfg), make_decode_step(tcfg)
    with torch.no_grad():
        tok, cache = pre(tparams, {"tokens": torch.from_numpy(toks).long()},
                         init_cache(tcfg, B, L, "cpu"))
        got = [tok.numpy()]
        for _ in range(steps):
            tok, cache = dec(tparams, {"tokens": tok.long()[:, None]}, cache)
            got.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


# ---------------------------------------------------------------------------
# (b), (c), (d) the engine on the slot pool
# ---------------------------------------------------------------------------

def test_slot_streams_equal_the_jax_slot_engine(model):
    jcfg, tcfg, jparams, tparams = model
    prompts = _prompts(jcfg.vocab_size)
    kw = dict(num_replicas=1, slots_per_replica=3, max_len=MAX_LEN,
              paged=False)
    want = _run(JaxServeEngine(jcfg, jparams, **kw), prompts)
    eng = ServeEngine(tcfg, tparams, device="cpu", **kw)
    assert eng.fns.cache_len == MAX_LEN
    got = _run(eng, prompts)
    assert got == want
    assert all(len(s) == GEN for s in got)


def test_paged_streams_equal_slot_streams_any_order(model):
    """tests/test_paged.py's contract for the port: the paged engine's
    greedy streams equal the slot pool's, in two arrival orders."""
    _, tcfg, _, tparams = model
    prompts = _prompts(tcfg.vocab_size)

    def run(paged, order):
        eng = ServeEngine(tcfg, tparams, device="cpu", num_replicas=1,
                          slots_per_replica=3, max_len=MAX_LEN, paged=paged)
        rids = {eng.submit(prompts[i], GEN): i for i in order}
        res = eng.run()
        if paged:
            for rep in eng.router.replicas.values():
                ok, detail = rep.pool.audit()
                assert ok, detail
        eng.shutdown()
        return {i: res[rid] for rid, i in rids.items()}

    slots = run(False, [0, 1, 2, 3, 4, 5])
    assert run(True, [0, 1, 2, 3, 4, 5]) == slots
    assert run(True, [5, 3, 1, 0, 2, 4]) == slots
    assert run(False, [5, 3, 1, 0, 2, 4]) == slots


def test_slot_pool_replica_kill_drops_nothing(granite):
    tcfg, tparams = granite
    prompts = _prompts(tcfg.vocab_size, n=8)
    kw = dict(num_replicas=2, slots_per_replica=3, max_len=MAX_LEN,
              paged=False, fault_tolerant=True, heartbeat_period=0.05,
              heartbeat_timeout_factor=40.0)
    clean = _run(ServeEngine(tcfg, tparams, device="cpu", **kw), prompts)
    inj = FaultInjector()
    inj.schedule_replica_kill(3, replica_id=1)
    eng = ServeEngine(tcfg, tparams, device="cpu", fault_injector=inj, **kw)
    got = _run(eng, prompts)
    assert got == clean
    assert eng.scheduler.failed_rids == []
    assert len(eng.scheduler.retried_rids) > 0
    assert [e["event"] for e in eng.events].count("replica_failed") == 1
    for rep in eng.router.replicas.values():
        assert rep.pool.free_count == rep.pool.num_slots


# ---------------------------------------------------------------------------
# (e) warm standby through CheckpointManager
# ---------------------------------------------------------------------------

def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return tree.numpy().copy()


def test_warm_standby_restored_past_a_corrupt_checkpoint(tmp_path, granite):
    """Kill the ONLY replica: a warm standby restored by the port from
    the reference's checkpoints takes over and finishes every request
    with the streams of an uninterrupted run.  The newest checkpoint
    holds other weights and is corrupt, so the standby must walk back
    past it."""
    tcfg, tparams = granite
    prompts = _prompts(tcfg.vocab_size, n=3)
    kw = dict(num_replicas=1, slots_per_replica=2, max_len=MAX_LEN,
              paged=False, fault_tolerant=True, heartbeat_period=0.05,
              heartbeat_timeout_factor=40.0)
    clean = _run(ServeEngine(tcfg, tparams, device="cpu", **kw), prompts)

    jm = JaxManager(str(tmp_path), fsync="none")
    jm.save(0, {"params": _np_tree(tparams)})
    wrong = _np_tree(tparams)
    wrong["embed"]["tok"] = -wrong["embed"]["tok"]
    jm.save(1, {"params": wrong})
    jm.close()
    victim = tmp_path / "step_00000001" / "params.embed.tok.s0_0.npy"
    raw = bytearray(victim.read_bytes())
    raw[-5] ^= 0x10
    victim.write_bytes(bytes(raw))

    manager = CheckpointManager(str(tmp_path), fsync="none")
    restored = []
    source = make_standby_source(manager, tparams)

    def standby():
        restored.append(source())
        return restored[-1]

    inj = FaultInjector()
    inj.schedule_replica_kill(2, replica_id=0)
    eng = ServeEngine(tcfg, tparams, device="cpu", fault_injector=inj, **kw)
    eng.add_standby(standby)
    got = _run(eng, prompts)
    manager.close()
    events = [e["event"] for e in eng.events]
    assert events.index("replica_failed") < events.index("standby_activated")
    assert got == clean
    assert eng.scheduler.failed_rids == []
    (params,) = restored
    want = flatten_named(tparams)
    have = flatten_named(params)
    assert [n for n, _ in have] == [n for n, _ in want]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(have, want))


# ---------------------------------------------------------------------------
# (f) the CLI
# ---------------------------------------------------------------------------

def test_cli_legacy_pool_with_a_standby():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--tiny",
         "--device", "cpu", "--legacy-pool", "--standbys", "1",
         "--kill-replica-at", "2", "--gen", "8", "--prompt-len", "12"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "served 8/8 requests" in out.stdout
    assert "x 4 slots on cpu" in out.stdout
    assert "standby_activated" in out.stdout
    assert "0 dropped" in out.stdout


# ---------------------------------------------------------------------------
# (g) idle slots past cache_len
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_idle_slot_past_cache_len_leaves_active_rows_alone(arch):
    _, tcfg = _configs(arch)
    params = init_params(tcfg, seed=4, device="cpu")
    cache_len, steps = 16, 12
    prefill = make_prefill_step(tcfg, pad_to=cache_len)
    decode = make_serve_decode_step(tcfg)
    prompt = torch.tensor([[5, 17, 3, 99]])

    def active_stream(idle_start):
        pool = CachePool(tcfg, 2, "cpu", cache_len=cache_len)
        with torch.no_grad():
            tok, row = prefill(params, {"tokens": prompt},
                               init_cache(tcfg, 1, cache_len, "cpu"))
            pool.write_row(0, row)
            pool.cache["index"][1] = idle_start
            out = [int(tok[0])]
            last = torch.tensor([[out[-1]], [7]])
            for _ in range(steps):
                toks, pool.cache, _ = decode(params, {"tokens": last},
                                             pool.cache)
                out.append(int(toks[0]))
                last = torch.tensor([[out[-1]], [int(toks[1])]])
        return out, pool.cache["index"].tolist()

    base, _ = active_stream(0)
    got, index = active_stream(cache_len - 3)
    assert index == [4 + steps, cache_len - 3 + steps]
    assert index[1] > cache_len
    assert got == base
