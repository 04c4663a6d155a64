"""The port's Mamba serving slice as a whole, on the CPU, against the JAX
package.

Tiny falcon-mamba in float32 on both sides, one set of weights
(``params_from_jax``).  A Mamba stack cannot page its state, so both
engines serve it through the slot pool:

- the port's ``ServeEngine(device="cpu")`` gives the JAX engine's greedy
  streams (JAX on its chunked scan and on its Pallas scan in interpret
  mode) and leaves every slot's conv and scan state where the JAX pool
  leaves it (random tiny weights repeat one token a lot, so the states
  are compared too);
- with a replica killed mid-decode both engines drain the same requests,
  drop nothing, and the retried streams are token-identical to an
  uninterrupted run (the tests/test_serve.py contract);
- one request trace drives both ``CachePool`` implementations through the
  same slots (the reference's slot order);
- ``paged=True`` on the SSM stack raises and the default picks the slot
  pool (tests/test_paged.py::test_paged_rejected_for_unpageable_stack).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FaultInjector as JaxFaultInjector
from repro.models import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.cache_pool import CachePool as JaxCachePool
from repro.serve.cache_pool import PoolExhausted as JaxPoolExhausted
from repro_torch.core import FaultInjector
from repro_torch.models import get_config, params_from_jax
from repro_torch.serve import ServeEngine
from repro_torch.serve.cache_pool import CachePool, PoolExhausted

ROOT = Path(__file__).resolve().parents[1]
JCFG = dataclasses.replace(jax_get_config("falcon-mamba-7b", tiny=True),
                           dtype=jnp.float32)
TCFG = dataclasses.replace(get_config("falcon-mamba-7b", tiny=True),
                           dtype=torch.float32)
ENGINE = dict(num_replicas=1, slots_per_replica=4, max_len=32)
GEN = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers beside
    timing-sensitive multi-process tests, and idle OpenMP threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jparams = jax_init_params(JCFG, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(jax.device_get(x)), jparams)
    return jparams, params_from_jax(TCFG, tree, device="cpu")


def _prompts():
    """7 prompts of assorted lengths: one token (the single-step branch),
    two (shorter than the conv window), an exact repeat."""
    rng = np.random.default_rng(11)

    def draw(n):
        return [int(t) for t in rng.integers(0, JCFG.vocab_size, n)]

    p0 = draw(10)
    return [p0, draw(1), draw(13), draw(2), list(p0), draw(7), draw(15)]


def _run(engine, prompts):
    rids = [engine.submit(p, GEN) for p in prompts]
    try:
        results = engine.run()
    finally:
        engine.shutdown()
    return [results[r] for r in rids]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_greedy_streams_and_pool_state_equal_the_jax_engine(weights,
                                                            use_pallas):
    jparams, tparams = weights
    prompts = _prompts()
    jcfg = dataclasses.replace(JCFG, use_pallas=use_pallas)
    jeng = JaxServeEngine(jcfg, jparams, **ENGINE)
    want = _run(jeng, prompts)
    eng = ServeEngine(TCFG, tparams, device="cpu", **ENGINE)
    got = _run(eng, prompts)
    assert got == want
    assert all(len(s) == GEN for s in got)
    assert not eng.paged and not jeng.paged
    # every slot's state after the run (the last occupants' and the stale
    # rows the pool kept decoding) where the JAX pool left it
    jcache = jeng.router.replicas[0].pool.cache["blocks"]["l0"]
    tcache = eng.router.replicas[0].pool.cache["layers"]
    for i, layer in enumerate(tcache):
        for name in ("conv", "h"):
            want_state = np.asarray(jcache[name][:, i, 0], np.float32)
            np.testing.assert_allclose(layer[name].numpy(), want_state,
                                       atol=1e-4, rtol=1e-4)


def test_replica_kill_drops_nothing_and_matches_the_jax_failover(weights):
    jparams, tparams = weights
    prompts = _prompts()
    # heartbeats on, with a timeout (2 s) that the JAX engine's first
    # compiles cannot reach: the injected kill is the one failure
    kw = dict(ENGINE, num_replicas=2, fault_tolerant=True,
              heartbeat_timeout_factor=40.0)
    clean = _run(ServeEngine(TCFG, tparams, device="cpu", **kw), prompts)
    runs = []
    for make, inj in ((lambda i: JaxServeEngine(JCFG, jparams,
                                                fault_injector=i, **kw),
                       JaxFaultInjector()),
                      (lambda i: ServeEngine(TCFG, tparams, device="cpu",
                                             fault_injector=i, **kw),
                       FaultInjector())):
        inj.schedule_replica_kill(3, replica_id=1)
        eng = make(inj)
        streams = _run(eng, prompts)
        assert eng.scheduler.failed_rids == []
        kinds = [e["event"] for e in eng.events]
        assert kinds.count("replica_failed") == 1
        runs.append((streams, list(eng.scheduler.retried_rids)))
    assert runs[1][0] == clean
    assert len(runs[1][1]) > 0
    assert runs[0] == runs[1]
    for rep in eng.router.replicas.values():
        assert rep.pool.free_count == rep.pool.num_slots


def _trace(pool, exhausted):
    """acquire / release / release_all, recording the slot accounting."""
    seen = []

    def snap(tag, out=None):
        seen.append((tag, out, pool.free_count, pool.active_slots,
                     [pool.owner(s) for s in range(pool.num_slots)]))

    for rid in (10, 11, 12):
        snap("acquire", pool.acquire(rid))
    pool.release(1)
    snap("release")
    snap("acquire", pool.acquire(13))
    snap("acquire", pool.acquire(14))
    with pytest.raises(exhausted):
        pool.acquire(15)
    pool.release(0)
    snap("release")
    with pytest.raises(ValueError):
        pool.release(0)
    snap("release_all", pool.release_all())
    snap("acquire", pool.acquire(16))
    return seen


def test_cache_pool_trace_matches_jax():
    jseen = _trace(JaxCachePool(JCFG, 4, 16), JaxPoolExhausted)
    tseen = _trace(CachePool(TCFG, 4, "cpu"), PoolExhausted)
    assert tseen == jseen
    assert tseen[-2][1] == [13, 12, 14]          # drained in slot order


def test_write_row_overwrites_the_whole_slot():
    pool = CachePool(TCFG, 3, "cpu")
    for layer in pool.cache["layers"]:
        for t in layer.values():
            t.fill_(7.0)
    pool.cache["index"].fill_(7)
    row = {"layers": [{n: torch.full_like(t[:1], float(i))
                       for n, t in layer.items()}
                      for i, layer in enumerate(pool.cache["layers"])],
           "index": torch.tensor([5], dtype=torch.int32)}
    pool.write_row(1, row)
    for i, layer in enumerate(pool.cache["layers"]):
        for t in layer.values():
            assert torch.all(t[1] == float(i))
            assert torch.all(t[0] == 7.0) and torch.all(t[2] == 7.0)
    assert pool.cache["index"].tolist() == [7, 5, 7]


def test_ssm_stack_cannot_page_and_defaults_to_slots(weights):
    _, tparams = weights
    with pytest.raises(ValueError, match="page"):
        ServeEngine(TCFG, tparams, device="cpu", max_len=16, paged=True)
    eng = ServeEngine(TCFG, tparams, device="cpu", max_len=16)
    assert not eng.paged
    assert isinstance(eng.router.replicas[0].pool, CachePool)
    eng.shutdown()
    # an attention stack's slot rows need a length, and get one
    gcfg = get_config("granite-3-8b", tiny=True)
    with pytest.raises(ValueError, match="cache_len"):
        CachePool(gcfg, 2, "cpu")
    pool = CachePool(gcfg, 2, "cpu", cache_len=16)
    k = pool.cache["layers"][0]["k"]
    assert k.shape == (2, 16, gcfg.num_kv_heads, gcfg.resolved_head_dim)
    assert pool.cache["layers"][0]["pos"].shape == (2, 16)
    assert pool.cache["index"].shape == (2,)


def test_cli_serves_the_mamba_slice():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve",
         "--arch", "falcon-mamba-7b", "--tiny", "--device", "cpu",
         "--replicas", "2", "--fault-tolerant", "--kill-replica-at", "3",
         "--gen", "8", "--prompt-len", "12"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "served 8/8 requests" in out.stdout
    assert "x 4 slots on cpu" in out.stdout
    assert "0 dropped" in out.stdout
