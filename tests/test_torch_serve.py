"""The port's serving slice as a whole, on the CPU, against the JAX package.

Tiny granite in float32 on both sides, one set of weights
(``params_from_jax``):

- the port's ``ServeEngine(device="cpu")`` gives the same greedy streams
  as the JAX ``ServeEngine`` for prompts with shared prefixes and an exact
  repeat, with the JAX engine on its default path and on its Pallas
  kernels (interpret mode);
- with a replica killed mid-decode the port drops nothing and its retried
  streams are token-identical to an uninterrupted run (the
  tests/test_serve.py contract);
- one request trace drives both ``PagedKVCache`` implementations to the
  same page tables, lengths and refcounts (the tests/test_paged.py
  contracts).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FaultInjector as JaxFaultInjector
from repro.models import get_config as jax_get_config
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.serve import PagedKVCache as JaxPagedKVCache
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.core import FaultInjector
from repro_torch.models import get_config, init_cache, params_from_jax
from repro_torch.serve import PagedKVCache, ServeEngine

JCFG = dataclasses.replace(jax_get_config("granite-3-8b", tiny=True),
                           dtype=jnp.float32)
TCFG = dataclasses.replace(get_config("granite-3-8b", tiny=True),
                           dtype=torch.float32)
ENGINE = dict(num_replicas=1, slots_per_replica=4, max_len=32, page_size=4)
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
    """8 prompts: 1 and 2 share an 8-token (two-page) prefix with 0, 5
    repeats 3 exactly, 6 shares an unaligned 6-token head with 4."""
    rng = np.random.default_rng(11)

    def draw(n):
        return [int(t) for t in rng.integers(0, JCFG.vocab_size, n)]

    p0, p3, p4 = draw(10), draw(12), draw(7)
    return [p0, p0[:8] + draw(5), p0[:8] + draw(3), p3, p4, list(p3),
            p4[:6] + draw(6), draw(15)]


def _run(engine, prompts):
    rids = [engine.submit(p, GEN) for p in prompts]
    try:
        results = engine.run()
    finally:
        engine.shutdown()
    return [results[r] for r in rids]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_greedy_streams_equal_the_jax_engine(weights, use_pallas):
    jparams, tparams = weights
    prompts = _prompts()
    jcfg = dataclasses.replace(JCFG, use_pallas=use_pallas)
    want = _run(JaxServeEngine(jcfg, jparams, **ENGINE), prompts)
    eng = ServeEngine(TCFG, tparams, device="cpu", **ENGINE)
    got = _run(eng, prompts)
    assert got == want
    assert all(len(s) == GEN for s in got)
    pool = eng.router.replicas[0].pool
    assert pool.prefix_hits >= 3             # shared prefixes + the repeat


def test_replica_kill_drops_nothing_and_retries_token_identical(weights):
    _, tparams = weights
    prompts = _prompts()
    # the kill is injected; a wide heartbeat timeout keeps host
    # scheduling from failing the survivor too
    kw = dict(ENGINE, num_replicas=2, fault_tolerant=True,
              heartbeat_timeout_factor=40.0)
    clean = _run(ServeEngine(TCFG, tparams, device="cpu", **kw), prompts)
    inj = FaultInjector()
    inj.schedule_replica_kill(3, replica_id=1)
    eng = ServeEngine(TCFG, tparams, device="cpu", fault_injector=inj, **kw)
    got = _run(eng, prompts)
    assert got == clean
    assert eng.scheduler.failed_rids == []
    assert len(eng.scheduler.retried_rids) > 0
    kinds = [e["event"] for e in eng.events]
    assert kinds.count("replica_failed") == 1
    cons = eng.page_conservation()
    assert cons["refs_ok"]
    assert cons["pages_free"] + cons["pages_held"] == cons["pages_total"]
    for rep in eng.router.replicas.values():
        ok, detail = rep.pool.audit()
        assert ok, detail


def test_jax_engine_kill_matches_the_port_kill(weights):
    """Both engines take the same failover path for the same trace: the
    same requests drain and every stream is the uninterrupted one."""
    jparams, tparams = weights
    prompts = _prompts()
    # the kill is injected; a wide heartbeat timeout keeps host
    # scheduling from failing the survivor too
    kw = dict(ENGINE, num_replicas=2, fault_tolerant=True,
              heartbeat_timeout_factor=40.0)
    drained = []
    for make, inj in ((lambda i: JaxServeEngine(JCFG, jparams,
                                                fault_injector=i, **kw),
                       JaxFaultInjector()),
                      (lambda i: ServeEngine(TCFG, tparams, device="cpu",
                                             fault_injector=i, **kw),
                       FaultInjector())):
        inj.schedule_replica_kill(3, replica_id=1)
        eng = make(inj)
        streams = _run(eng, prompts)
        drained.append((streams, list(eng.scheduler.retried_rids)))
    assert drained[0] == drained[1]


def _trace(pool, fresh_row):
    """acquire / grow / copy-on-write / exact-repeat / release /
    release_all, recording the pool's host state after every step."""
    seen = []

    def snap(tag):
        ok, detail = pool.audit()
        assert ok, (tag, detail)
        seen.append((tag, pool.page_tables.copy(), pool.lengths.copy(),
                     pool._refs.copy(), pool.free_pages,
                     pool.available()))

    a = list(range(1, 7))                    # unaligned: 1.5 pages at ps=4
    r0, plan = pool.acquire(10, a, 5)
    pool.write_prefill(r0, fresh_row)
    pool.register_prefix(r0, a, 9)
    snap("acquire")
    for _ in range(4):                       # cow at 6, grow at 8
        pool.ensure_writable(r0)
        pool.advance(r0)
        snap("decode")
    r1, plan = pool.acquire(11, a[:4] + [50, 51, 52], 3)
    assert plan.shared == 1
    pool.write_prefill(r1, fresh_row)
    pool.register_prefix(r1, a[:4] + [50, 51, 52], 4)
    snap("share-aligned-prefix")
    r2, plan = pool.acquire(12, list(a), 3)
    assert plan.skip_prefill and plan.first_token == 9
    snap("exact-repeat")
    assert pool.ensure_writable(r2) == "cow"
    pool.advance(r2)
    snap("cow")
    pool.release(r0)
    snap("release")
    drained = pool.release_all()
    snap("release_all")
    return seen, drained, pool.last_drain


def test_paged_kv_cache_trace_matches_jax():
    geo = dict(num_pages=17, page_size=4, cache_len=16, max_active=4,
               prefix=True)
    jseen, jdrained, jlast = _trace(JaxPagedKVCache(JCFG, **geo),
                                    jax_init_cache(JCFG, 1, 16))
    tseen, tdrained, tlast = _trace(PagedKVCache(TCFG, device="cpu", **geo),
                                    init_cache(TCFG, 1, 16, "cpu"))
    assert tdrained == jdrained == [11, 12]
    assert tlast == jlast
    assert len(tseen) == len(jseen)
    for (tag, *t), (_, *j) in zip(tseen, jseen):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b, err_msg=tag)
