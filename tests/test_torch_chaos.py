"""The port's chaos scenario engine against the JAX package's
(``repro.chaos``), on the CPU: the control-plane simulator field for
field, the storm schedules and the training driver's compiled actions.
The serving driver is held to the reference's in
``test_torch_chaos_serve.py``, and the rank-mesh runs of
``run_scenario_elastic`` are in ``test_torch_chaos_mesh.py``."""
import dataclasses
import glob
import os
import signal as signal_module
import time

import numpy as np
import pytest

import repro.chaos as RC
import repro_torch.chaos as PC
from repro.chaos.driver import _storm_flips as ref_storm_flips
from repro.core import elastic as RE
from repro_torch.chaos.driver import _storm_flips
from repro_torch.core import elastic as PE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = os.path.join(ROOT, "scenarios")
NAMES = sorted(os.path.basename(p)[:-5]
               for p in glob.glob(os.path.join(SCENARIOS, "*.json")))


def _load(pkg, name):
    return pkg.Scenario.from_json(os.path.join(SCENARIOS, name + ".json"))


def _spec(E, kind):
    """The 3D ``MeshSpec`` cases of tests/test_elastic_3d.py, built from
    ``E`` (either package's ``core.elastic``)."""
    if kind == "3d-small":
        return E.MeshSpec(data=2, model=2, expert=2, legal_model=(1, 2),
                          num_experts=8)
    if kind == "3d-scale":
        return E.MeshSpec(data=500, model=2, expert=8, legal_model=(1, 2),
                          num_experts=64)
    # tiny mixtral's spec, as test_e2e_3d_mesh_survives_host_kill sizes it
    from repro_torch.models import get_config
    cfg = get_config("mixtral-8x7b", tiny=True)
    heads = cfg.num_kv_heads
    return E.MeshSpec(data=2, model=2, expert=2,
                      legal_model=tuple(t for t in (1, 2)
                                        if heads % t == 0),
                      num_experts=cfg.num_experts)


# (num_hosts, kwargs, 3D spec kind or None)
SIM_CASES = {
    "4": (4, {}, None),
    "4-period": (4, {"period": 0.1}, None),
    "8x2-tp2": (8, {"devices_per_host": 2, "model_axis": 2}, None),
    "1000-rate20": (1000, {"base_rate": 20}, None),
    "4-queue": (4, {"base_rate": 3, "slots_per_host": 2,
                    "service_ticks": 2}, None),
    "4x2-3d": (4, {"devices_per_host": 2}, "3d-small"),
    "4x2-mixtral": (4, {"devices_per_host": 2}, "mixtral"),
    "1000x2-3d": (1000, {"devices_per_host": 2}, "3d-scale"),
}


def _report(rep):
    """Every field of a SimReport but ``wall_seconds``."""
    out = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)
           if f.name != "wall_seconds"}
    out["invariants"] = [(r.name, bool(r.passed), r.detail)
                         for r in rep.invariants]
    d = rep.to_dict()
    d.pop("wall_seconds")
    out["to_dict"] = d
    return out


def _sims(case):
    n, kw, kind = SIM_CASES[case]
    ref = RC.ControlPlaneSim(n, mesh_spec=_spec(RE, kind) if kind else None,
                             **kw)
    port = PC.ControlPlaneSim(n, mesh_spec=_spec(PE, kind) if kind else None,
                              **kw)
    return ref, port


@pytest.mark.parametrize("case", sorted(SIM_CASES))
@pytest.mark.parametrize("name", NAMES)
def test_sim_report_equals_reference(name, case):
    ref, port = _sims(case)
    want = _report(ref.run(_load(RC, name)))
    got = _report(port.run(_load(PC, name)))
    assert got == want
    assert got["to_dict"]["invariant_pass_rate"] == 1.0, got["invariants"]


@pytest.mark.parametrize("case", ["4x2-3d", "4x2-mixtral", "1000x2-3d"])
def test_sim_host_coords_equal_reference(case):
    ref, port = _sims(case)
    n = SIM_CASES[case][0]
    for members in (None, [0, 2, 3], list(range(1, n, 3))):
        assert port.host_coords(members) == ref.host_coords(members)


def test_sim_thousand_hosts_compound():
    """The reference's acceptance bar on the port's sim: 1000 virtual
    hosts through the compound trace, every invariant green."""
    t0 = time.perf_counter()
    rep = PC.ControlPlaneSim(1000, base_rate=20).run(_load(PC, "compound"))
    assert time.perf_counter() - t0 < 60.0
    assert {d["host"] for d in rep.detections} == {2, 3}
    assert rep.stale_delivered > 0
    assert rep.stale_rejected == rep.stale_delivered
    assert sorted(h for _, hs in rep.grow_events for h in hs) == [2, 3]
    assert rep.cadence_ok
    PC.verify(rep.invariants)


def test_sim_no_survivors_raises_like_reference():
    for pkg, err in ((RC, RE.NoSurvivorsError), (PC, PE.NoSurvivorsError)):
        sc = pkg.Scenario("dead").kill_hosts([0, 1], at=2)
        with pytest.raises(err, match="every host dead at t=") as e:
            pkg.ControlPlaneSim(2).run(sc)
        if pkg is RC:
            want = str(e.value)
    assert str(e.value) == want


@pytest.mark.parametrize("period", [0.1, 0.05, 0.25])
def test_sim_time_clock_equals_reference(period):
    back = float(np.random.default_rng(int(period * 100)).uniform(2.0, 3.0))
    reports = []
    for pkg in (RC, PC):
        sc = (pkg.Scenario("t", clock="time", seed=3)
              .kill_hosts([1], at=0.5)
              .partition([[0, 1], [2, 3]], at=1.0, heal_at=2.5)
              .traffic_spike(mult=3, window=(0.3, 1.7))
              .rejoin(1, at=back))
        reports.append(_report(pkg.ControlPlaneSim(
            4, period=period, base_rate=2).run(sc)))
    assert reports[1] == reports[0]
    assert reports[1]["detections"][0]["t_lost"] == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# storm schedules and the training driver's compilation
# ---------------------------------------------------------------------------

def _random_scenarios(pkg, n=12):
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        a = int(rng.integers(0, 10))
        sc = pkg.Scenario(f"r{i}", seed=int(rng.integers(0, 10 ** 6)))
        sc.sdc_storm(rate=float(rng.uniform(0.05, 1.0)),
                     window=(a, a + int(rng.integers(1, 30))),
                     max_bit=int(rng.integers(1, 64)))
        out.append(sc)
    return out


def test_storm_flips_equal_reference():
    leaves = ["params.blocks.l0.attn.wk", "params.embed.tok",
              "params.final_norm"]
    cases = ([(_load(RC, n), _load(PC, n)) for n in NAMES]
             + list(zip(_random_scenarios(RC), _random_scenarios(PC))))
    n = 0
    for ref, port in cases:
        for er, ep in zip(ref.window_events("sdc_storm"),
                          port.window_events("sdc_storm")):
            for names in (leaves, leaves[:1]):
                want = ref_storm_flips(ref, er, names)
                assert _storm_flips(port, ep, names) == want
                n += len(want)
    assert n > 50


def _no_sleep(pkg):
    """The reference's training driver sleeps after each action unless
    told not to; the port's never sleeps."""
    return {"settle_seconds": 0} if pkg is RC else {}


class _FakeEmitter:
    def __init__(self):
        self.paused = 0
        self.resumed = 0
        self.send_filter = None

    def pause(self):
        self.paused += 1

    def resume(self):
        self.resumed += 1


def _drive(pkg, sc, steps, n_hosts=4, **kw):
    """A training driver over fake emitters, fed ``steps`` (a replay is a
    step seen again); its reports and each emitter's counts."""
    ems = {h: _FakeEmitter() for h in range(n_hosts)}
    d = pkg.TrainScenarioDriver(sc, emitters=ems,
                                leaf_names=["params.w", "params.v"],
                                **_no_sleep(pkg), **kw)
    for s in steps:
        d.on_metrics(s, {"step": s, "loss": 1.0 / s})
    gates = {h: e.send_filter is not None for h, e in ems.items()}
    return {"applied": d.applied, "report": d.report(),
            "pending": d.injector.pending(),
            "dead": d.dead_intervals(), "history": d.history(),
            "emitters": {h: (e.paused, e.resumed) for h, e in ems.items()},
            "gates": gates}


TRAIN_TRACES = {
    "compound": (None, list(range(1, 21))),
    "rack_loss": (None, [1, 2, 3, 4, 5, 3, 4, 5, 6] + list(range(7, 16))),
    "partition_heal": (None, list(range(1, 8))),
    "partition_heal-healed": ("partition_heal", list(range(1, 12))),
    "precursor_storm": (None, list(range(1, 18))),
    "axis_loss": (None, list(range(1, 10)) + list(range(6, 18))),
    "straggler": (None, list(range(1, 10))),
    "sdc_storm": (None, list(range(1, 13))),
}


@pytest.mark.parametrize("trace", sorted(TRAIN_TRACES))
def test_train_driver_equals_reference(trace):
    name, steps = TRAIN_TRACES[trace]
    name = name or trace
    want = _drive(RC, _load(RC, name), steps)
    got = _drive(PC, _load(PC, name), steps)
    assert got == want


def test_train_driver_fires_actions_once_across_rollback_replay():
    out = []
    for pkg in (RC, PC):
        sc = (pkg.Scenario("s").kill_hosts([1, 2], at=3)
              .partition([[0], [3]], at=5, heal_at=7).rejoin(1, at=8))
        got = _drive(pkg, sc, [1, 2, 3, 4, 2, 3, 4, 5, 7, 8])
        assert got["emitters"] == {0: (0, 0), 1: (1, 1), 2: (1, 0),
                                   3: (0, 0)}
        assert [a["phase"] for a in got["applied"]] == [
            "kill", "partition", "heal", "rejoin"]
        assert [h["step"] for h in got["history"]] == [1, 2, 3, 4, 5, 7, 8]
        assert got["history"][1]["loss"] == 1.0 / 2
        assert got["dead"] == {1: [(3.0, 8.0)], 2: [(3.0, float("inf"))]}
        out.append(got)
    assert out[1] == out[0]


def test_train_driver_refuses_missing_emitters_and_time_clock():
    for pkg in (RC, PC):
        with pytest.raises(pkg.ScenarioError, match="host 5"):
            pkg.TrainScenarioDriver(pkg.Scenario("s").kill_hosts([5], at=3),
                                    emitters={0: _FakeEmitter(),
                                              1: _FakeEmitter()})
        with pytest.raises(pkg.ScenarioError, match="clock"):
            pkg.TrainScenarioDriver(pkg.Scenario("s", clock="time"))
        d = pkg.TrainScenarioDriver(
            pkg.Scenario("s").traffic_spike(mult=4, window=(1, 5)),
            **_no_sleep(pkg))
        assert d.report()["skipped"] == ["traffic_spike"]
        with pytest.raises(pkg.ScenarioError, match="no target leaves"):
            pkg.TrainScenarioDriver(
                pkg.Scenario("s").sdc_storm(rate=0.5, window=(1, 4)))
    # on a rank mesh the run's hosts are checked, not the emitters held
    sc = PC.Scenario("s").kill_hosts([3], at=2).rejoin(3, at=4)
    d = PC.TrainScenarioDriver(sc, emitters={1: _FakeEmitter()},
                               hosts=[0, 1, 2, 3])
    d.on_metrics(2, {"step": 2})
    assert [a["phase"] for a in d.applied] == ["kill"]
    with pytest.raises(PC.ScenarioError, match="host 3"):
        PC.TrainScenarioDriver(sc, emitters={1: _FakeEmitter()},
                               hosts=[0, 1, 2])


@pytest.mark.parametrize("preempts", [True, False])
def test_train_driver_preempt_signals(preempts):
    got = []
    prev = signal_module.signal(signal_module.SIGUSR1,
                                lambda s, f: got.append(s))
    try:
        d = PC.TrainScenarioDriver(PC.Scenario("s").preempt(at=2),
                                   preempts=preempts)
        d.on_metrics(1, {"step": 1})
        assert got == []
        d.on_metrics(2, {"step": 2})
        time.sleep(0.05)
        assert got == ([signal_module.SIGUSR1] if preempts else [])
        assert [a["phase"] for a in d.applied] == ["preempt"]
    finally:
        signal_module.signal(signal_module.SIGUSR1, prev)


@pytest.mark.parametrize("jsonl", [False, True])
def test_train_driver_obs_records_equal_reference(tmp_path, jsonl):
    """tests/test_obs.py's declarative round trip in both packages: the
    same chaos events on the bus, the same Scenario back."""
    import repro.obs as RO
    import repro_torch.obs as PO

    out = []
    for pkg, obs_pkg in ((RC, RO), (PC, PO)):
        sc = (pkg.Scenario("compound", clock="step", seed=42)
              .kill_hosts([2, 3], at=6)
              .sdc_storm(rate=0.3, window=(4, 10))
              .traffic_spike(mult=4, window=(3, 12))
              .rejoin(2, at=16)
              .rejoin(3, at=16))
        path = str(tmp_path / f"{pkg.__name__}.jsonl") if jsonl else None
        obs = obs_pkg.Observability(jsonl_path=path)
        d = pkg.TrainScenarioDriver(
            sc, emitters={h: _FakeEmitter() for h in range(4)},
            leaf_names=["params.w"], obs=obs, **_no_sleep(pkg))
        for s in (5, 6, 7):
            d.on_metrics(s, {"step": s, "loss": 0.5})
        evs = obs.events(subsystem="chaos")
        records = [(e.kind, dict(e.data)) for e in evs]
        injector = [(e.kind, dict(e.data))
                    for e in obs.events(subsystem="injector")]
        if jsonl:
            obs.close()
            back = obs_pkg.to_scenario(obs_pkg.load_jsonl(path))
        else:
            back = obs.to_scenario()
        assert back.to_dict() == sc.to_dict()
        assert obs.to_scenario(name="renamed").name == "renamed"
        out.append((records, injector, back.to_dict(), d.history()))
    assert out[1] == out[0]
