"""The port's ``ServeScenarioDriver`` against the JAX package's
(``repro.chaos``) on tiny float32 granite engines on the CPU: the same
submitted prompts, report, conservation and page samples and token
streams for ``compound`` (paged and slot pool), ``flash_crowd`` and
``flash_crowd_paged``, and compound's streams equal to the port's own
B=1 prefill and decode."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import repro.chaos as RC
import repro_torch.chaos as PC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = os.path.join(ROOT, "scenarios")


def _load(pkg, name):
    return pkg.Scenario.from_json(os.path.join(SCENARIOS, name + ".json"))


@pytest.fixture(scope="module")
def tiny():
    import jax
    import jax.numpy as jnp
    from repro.models import get_config as jax_get_config
    from repro.models import init_params as jax_init_params
    from repro_torch.models import get_config, params_from_jax

    jcfg = dataclasses.replace(jax_get_config("granite-3-8b", tiny=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config("granite-3-8b", tiny=True),
                               dtype=torch.float32)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(jax.device_get(x)), jparams)
    return jcfg, jparams, tcfg, params_from_jax(tcfg, tree, device="cpu")


# trace -> (engine kwargs, standbys, driver kwargs): the reference's own
# set-ups (tests/test_chaos.py, tests/test_paged.py)
SERVE_CASES = {
    "compound": (dict(num_replicas=4, slots_per_replica=2, max_len=32,
                      fault_tolerant=True, heartbeat_period=0.05,
                      heartbeat_timeout_factor=40.0, max_pending=256,
                      max_retries=8), 4,
                 dict(base_rate=1, prompt_len=6, max_new_tokens=6)),
    "compound-slots": (dict(num_replicas=4, slots_per_replica=2,
                            max_len=32, fault_tolerant=True,
                            heartbeat_period=0.05,
                            heartbeat_timeout_factor=40.0, max_pending=256,
                            max_retries=8, paged=False), 4,
                       dict(base_rate=1, prompt_len=6, max_new_tokens=6)),
    "partition_heal": (dict(num_replicas=4, slots_per_replica=2,
                            max_len=32, fault_tolerant=True,
                            heartbeat_period=0.05,
                            heartbeat_timeout_factor=40.0,
                            max_pending=256, max_retries=8), 0,
                       dict(base_rate=4, prompt_len=6, max_new_tokens=6)),
    "flash_crowd": (dict(num_replicas=1, slots_per_replica=2, max_len=16,
                         fault_tolerant=False, max_pending=6), 0,
                    dict(base_rate=2, prompt_len=4, max_new_tokens=4)),
    "flash_crowd_paged": (dict(num_replicas=2, slots_per_replica=4,
                               max_len=32, fault_tolerant=True,
                               heartbeat_period=0.05,
                               heartbeat_timeout_factor=40.0,
                               max_pending=512, max_prefill_per_step=16,
                               paged=True, max_active=64, num_pages=200), 0,
                          dict(base_rate=1, prompt_len=8,
                               max_new_tokens=16)),
}


def _serve_run(pkg, engine_cls, cfg, params, case):
    eng_kw, standbys, drv_kw = SERVE_CASES[case]
    eng = engine_cls(cfg, params, **eng_kw)
    for _ in range(standbys):
        eng.add_standby(lambda: params)
    drv = pkg.ServeScenarioDriver(eng, _load(pkg, case.split("-")[0]),
                                  **drv_kw)
    try:
        results = drv.run()
        checks = [pkg.check_zero_drop(eng.scheduler, drv.submitted_rids),
                  pkg.check_conservation(drv.samples),
                  pkg.check_monotonic_drain(drv.drained_series)]
        if eng.paged:
            checks.append(pkg.check_page_conservation(drv.page_samples))
        failures = [e for e in eng.events if e["event"] == "replica_failed"]
        return {"prompts": drv.prompts, "rids": drv.submitted_rids,
                "report": drv.report(), "samples": drv.samples,
                "page_samples": drv.page_samples,
                "drained": drv.drained_series, "results": results,
                "paged": bool(eng.paged),
                "reasons": sorted(":".join(e["reason"].split(":")[:2])
                                  for e in failures),
                "checks": [(c.name, bool(c.passed)) for c in checks]}
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def port_runs(tiny):
    """The port's run of each case, once for the module's tests."""
    from repro_torch.serve import ServeEngine

    _, _, cfg, params = tiny
    runs = {}

    def get(case):
        if case not in runs:
            runs[case] = _serve_run(
                PC, lambda *a, **k: ServeEngine(*a, device="cpu", **k),
                cfg, params, case)
        return runs[case]
    return get


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serve_driver_equals_reference(tiny, port_runs, case):
    from repro.serve import ServeEngine as RServe

    jcfg, jparams, _, _ = tiny
    want = _serve_run(RC, RServe, jcfg, jparams, case)
    got = port_runs(case)
    for key in ("prompts", "rids", "report", "samples", "page_samples",
                "drained", "paged", "reasons", "checks", "results"):
        assert got[key] == want[key], key
    assert all(ok for _, ok in got["checks"]), got["checks"]
    rep = got["report"]
    if case.startswith("compound"):
        assert rep["skipped"] == ["rejoin"] and rep["retried"] > 0
        assert "injected:replica-kill" in got["reasons"]
        assert any(r.startswith("sentinel:") for r in got["reasons"])
    elif case == "partition_heal":
        # the cut side (replicas 2 and 3) is declared and drained
        assert rep["retried"] > 0 and rep["skipped"] == []
        assert got["reasons"] and all(r.startswith("heartbeat")
                                      for r in got["reasons"])
    elif case == "flash_crowd":
        assert rep["rejected"] > 0 and rep["skipped"] == []
    else:
        assert rep["rejected"] == 0 and rep["retried"] > 0
        assert max(s["in_flight"] for s in got["samples"]) >= 100


@pytest.mark.parametrize("case", ["compound", "compound-slots"])
def test_serve_driver_oracle_streams(tiny, port_runs, case):
    """The compound trace's streams on the port's engine, paged and slot
    pool, equal its own B=1 prefill/decode, every request (the
    reference's E2E oracle)."""
    from repro_torch.models import init_cache
    from repro_torch.train import make_decode_step, make_prefill_step

    _, _, cfg, params = tiny
    run = port_runs(case)
    gen = SERVE_CASES[case][2]["max_new_tokens"]
    pre, dec = make_prefill_step(cfg), make_decode_step(cfg)
    ref = {}
    with torch.no_grad():
        for rid in run["rids"]:
            toks = torch.tensor([run["prompts"][rid]], dtype=torch.int32)
            tok, row = pre(params, {"tokens": toks},
                           init_cache(cfg, 1, 32, device="cpu"))
            s = [int(tok[0])]
            for _ in range(gen - 1):
                tok, row = dec(params, {"tokens": tok[:, None]}, row)
                s.append(int(tok[0]))
            ref[rid] = s
    PC.verify([PC.check_token_identical(run["results"], ref)])


def test_serve_driver_rejects_time_clock(tiny):
    from repro_torch.serve import ServeEngine

    _, _, cfg, params = tiny
    eng = ServeEngine(cfg, params, device="cpu", num_replicas=1,
                      slots_per_replica=2, max_len=16)
    with pytest.raises(PC.ScenarioError, match="clock"):
        PC.ServeScenarioDriver(eng, PC.Scenario("t", clock="time"))
    eng.shutdown()
