"""The port's telemetry records on the CPU against the JAX package's
(``repro.obs``, ``repro.chaos.scenario``): the same events give the same
bytes and the same numbers in both.

- the event bus: payload checks, ``Event`` dicts, JSONL logs written by
  one package and read by the other, segment rotation, pruning and the
  numbering of a re-attached sink (byte for byte, on a fixed clock);
- the metrics registry: percentiles, ``Span``, the JSON snapshot and the
  Prometheus text (custom quantiles, escaped label values);
- ``Timeline`` incidents and summary, the Chrome trace and
  ``to_scenario`` on both paths (the declarative ``chaos/*`` events the
  reference's drivers record, and detections from a production log),
  for explicit ``t_mono`` stamps;
- the ``Observability`` bundle (``snapshot``, ``dump``'s four files);
- the facade and the BSP loop with telemetry attached: save, restore,
  SDC, interrupted and resume events and instruments as the reference
  emits them, ``observe_recovery`` fed by the measured restore.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

import repro.obs as R
import repro.obs.bus as R_bus
import repro_torch.obs as P
import repro_torch.obs.bus as P_bus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both buses stamp from one deterministic clock: t_mono 1.5, 2.0,
    2.5, ... and t_wall 1e9 + the same (a fresh count per bus module)."""
    def fake():
        n = [0]

        def tick():
            n[0] += 1
            return 1.0 + 0.5 * n[0]
        return types.SimpleNamespace(perf_counter=tick,
                                     time=lambda: 1e9 + 0.5 * n[0])
    monkeypatch.setattr(R_bus, "time", fake())
    monkeypatch.setattr(P_bus, "time", fake())


def _ev(pkg, t, subsystem, kind, **data):
    return pkg.Event(seq=int(t * 1000), t_mono=t, t_wall=1e9 + t,
                     subsystem=subsystem, kind=kind, data=data)


def _same(ref_events, port_events):
    assert [e.to_dict() for e in port_events] == \
        [e.to_dict() for e in ref_events]


# ---------------------------------------------------------------------------
# event bus
# ---------------------------------------------------------------------------

def test_bus_stamps_and_filters_like_the_reference(fixed_clock):
    buses = (R.EventBus(), P.EventBus())
    for bus in buses:
        bus.emit("heartbeat", "failure", host=3)
        bus.emit("checkpoint", "save", step=10, save_kind="full")
        bus.emit("heartbeat", "rejoin", host=3)
    ref, port = buses
    _same(ref.events(), port.events())
    _same(ref.events(subsystem="heartbeat"),
          port.events(subsystem="heartbeat"))
    _same(ref.events(kind="save"), port.events(kind="save"))
    assert (len(port), port.total_emitted) == (len(ref), ref.total_emitted)


def test_bus_ring_bound_and_reserved_keys():
    ref, port = R.EventBus(capacity=5), P.EventBus(capacity=5)
    for bus in (ref, port):
        for i in range(12):
            bus.emit("s", "k", i=i)
        with pytest.raises(ValueError, match="seq"):
            bus.emit("s", "k", seq=7, t_mono=0.0)
    assert (port.dropped, len(port), port.total_emitted) == \
        (ref.dropped, len(ref), ref.total_emitted) == (7, 5, 12)
    assert [e.data for e in port.events()] == [e.data for e in ref.events()]
    assert P.DEFAULT_CAPACITY == R.DEFAULT_CAPACITY


def test_event_dicts_cross_the_packages():
    d = {"seq": 4, "t_mono": 12.25, "t_wall": 1e9 + 3.5,
         "subsystem": "sdc", "kind": "corruption", "step": 7,
         "tier": "scrub", "detail": "params.w"}
    p, r = P.Event.from_dict(d), R.Event.from_dict(d)
    assert p.to_dict() == r.to_dict() == d
    assert R.Event.from_dict(p.to_dict()) == r
    assert P.Event.from_dict({}).to_dict() == R.Event.from_dict({}).to_dict()


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_jsonl_written_by_one_package_read_by_the_other(tmp_path, writer,
                                                        reader):
    pkgs = {"port": P, "ref": R}
    path = str(tmp_path / "events.jsonl")
    w = pkgs[writer].Observability(jsonl_path=path)
    w.emit("train", "step", step=1, seconds=0.25, loss=2.5, straggler=False)
    w.emit("checkpoint", "restore", step=0, restore_s=0.125, skipped=[])
    w.emit("precursor", "step_time_drift", host=0, score=1.0, risk=1.0)
    w.close()
    got = pkgs[reader].load_jsonl(path)
    assert [e.to_dict() for e in got] == [e.to_dict() for e in w.events()]


def _emit_n(bus, n):
    for i in range(n):
        bus.emit("bench", "tick", step=i, payload="x" * (i % 7))


def _files(d):
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("max_bytes,max_segments,n", [
    (600, 50, 40),        # rotation keeps the stream in order
    (400, 3, 60),         # pruning keeps only the newest segments
    (None, 8, 30),        # unbounded: no rotation at all
])
def test_jsonl_rotation_and_pruning_match_the_reference(tmp_path, fixed_clock,
                                                        max_bytes,
                                                        max_segments, n):
    dirs = {}
    for name, pkg in (("ref", R), ("port", P)):
        d = tmp_path / name
        d.mkdir()
        bus = pkg.EventBus()
        bus.attach_jsonl(str(d / "t.jsonl"), max_bytes=max_bytes,
                         max_segments=max_segments)
        _emit_n(bus, n)
        bus.close()
        dirs[name] = str(d)
    assert _files(dirs["port"]) == _files(dirs["ref"])
    if max_bytes is not None:
        assert len(_files(dirs["port"])) > 1
    port = P.load_jsonl(os.path.join(dirs["port"], "t.jsonl"))
    ref = R.load_jsonl(os.path.join(dirs["ref"], "t.jsonl"))
    _same(ref, port)
    steps = [e.data["step"] for e in port]
    assert steps == sorted(steps) and steps[-1] == n - 1


def test_jsonl_reattach_resumes_segment_numbering(tmp_path, fixed_clock):
    dirs = {}
    for name, pkg in (("ref", R), ("port", P)):
        d = tmp_path / name
        d.mkdir()
        path = str(d / "t.jsonl")
        for _ in range(2):
            bus = pkg.EventBus()
            bus.attach_jsonl(path, max_bytes=300, max_segments=50)
            _emit_n(bus, 15)
            bus.close()
        dirs[name] = str(d)
    assert _files(dirs["port"]) == _files(dirs["ref"])
    assert P_bus._segment_indices(os.path.join(dirs["port"], "t.jsonl")) == \
        R_bus._segment_indices(os.path.join(dirs["ref"], "t.jsonl"))
    assert len(P.load_jsonl(os.path.join(dirs["port"], "t.jsonl"))) == 30


def test_jsonl_sink_validation_and_missing_file(tmp_path):
    for pkg in (R, P):
        with pytest.raises(ValueError, match="max_bytes"):
            pkg.EventBus().attach_jsonl(str(tmp_path / "x.jsonl"),
                                        max_bytes=0)
        with pytest.raises(FileNotFoundError):
            pkg.load_jsonl(str(tmp_path / "missing.jsonl"))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _fill(reg, seed=0):
    rng = np.random.default_rng(seed)
    reg.counter("checkpoint.saves", kind="full").inc(3)
    reg.counter("checkpoint.saves", kind="delta").inc(5)
    reg.counter("checkpoint.bytes").inc(1.5e9)
    reg.gauge("serve.queue_depth").set(7)
    g = reg.gauge("serve.in_flight")
    g.inc(4)
    g.dec(1.5)
    reg.counter("sdc.detected", tier='sc"r\\ub\nx').inc()
    for v in rng.exponential(20.0, size=300):
        reg.histogram("train.step_ms").observe(float(v))
    for v in rng.normal(5.0, 1.0, size=40):
        reg.histogram("checkpoint.restore_ms", host=2).observe(float(v))
    return reg


@pytest.mark.parametrize("quantiles", [None, (0.5, 0.9, 0.999), (0.0, 1.0),
                                       ()])
def test_prometheus_text_is_byte_identical(quantiles):
    ref, port = _fill(R.MetricsRegistry()), _fill(P.MetricsRegistry())
    kw = {} if quantiles is None else {"quantiles": quantiles}
    text = port.to_prometheus(**kw)
    assert text == ref.to_prometheus(**kw)
    assert 'tier="sc\\"r\\\\ub\\nx"' in text
    if quantiles is None:
        assert text == port.to_prometheus(quantiles=(0.5, 0.99))


def test_prometheus_quantile_validation():
    for pkg in (R, P):
        with pytest.raises(ValueError, match="quantile"):
            pkg.MetricsRegistry().to_prometheus(quantiles=(1.5,))


def test_snapshot_and_json_match_the_reference(tmp_path):
    ref, port = _fill(R.MetricsRegistry(), 3), _fill(P.MetricsRegistry(), 3)
    assert port.snapshot() == ref.snapshot()
    text = port.to_json(str(tmp_path / "m.json"))
    assert text == ref.to_json()
    assert json.load(open(tmp_path / "m.json")) == json.loads(text)


@pytest.mark.parametrize("q", [0.0, 12.5, 50.0, 90.0, 99.0, 100.0])
def test_histogram_percentiles_and_moments(q):
    xs = np.random.default_rng(int(q)).lognormal(size=257)
    ref, port = R.MetricsRegistry(), P.MetricsRegistry()
    hs = [reg.histogram("h", window=200) for reg in (ref, port)]
    for h in hs:
        for v in xs:
            h.observe(float(v))
    r, p = hs
    assert p.percentile(q) == r.percentile(q) == pytest.approx(
        np.percentile(xs[-200:], q))
    assert (p.count, p.sum, p.mean, p.p50, p.p99) == \
        (r.count, r.sum, r.mean, r.p50, r.p99)


def test_gauge_inc_dec_span_and_type_conflicts():
    reg = P.MetricsRegistry()
    g = reg.gauge("alive")
    g.inc(3)
    g.dec()
    assert g.value == 2.0
    with reg.span("checkpoint.critical_path_ms") as sp:
        pass
    h = reg.histogram("checkpoint.critical_path_ms")
    assert h.count == 1 and sp.seconds >= 0
    assert h.p50 == pytest.approx(sp.seconds * 1e3)
    with pytest.raises(TypeError):
        reg.counter("alive")
    assert P.metrics._escape_label('a"b\\c\nd') == \
        R.metrics._escape_label('a"b\\c\nd')


# ---------------------------------------------------------------------------
# timelines and exports, on explicit stamps
# ---------------------------------------------------------------------------

TIMELINES = {
    "merged-and-second": [
        (0.0, "train", "step", {"step": 0}),
        (1.0, "heartbeat", "failure", {"host": 2}),
        (1.1, "sdc", "corruption", {"step": 6}),
        (1.2, "elastic", "shrink", {"hosts": [2]}),
        (1.5, "checkpoint", "restore", {"step": 4}),
        (2.0, "elastic", "resume", {"step": 4}),
        (5.0, "serve", "replica_failed", {"replica": 1, "hosts": [1]}),
        (5.5, "serve", "standby_activated", {"replica": 4}),
        (6.0, "serve", "retry_first_token", {"rid": 9}),
        (10.0, "train", "step", {"step": 20}),
    ],
    "open-until-log-end": [
        (0.0, "train", "step", {"step": 0}),
        (4.0, "heartbeat", "failure", {"host": 1}),
        (10.0, "train", "step", {"step": 9}),
    ],
    "resume-without-incident": [
        (1.0, "train", "resume", {"step": 3}),
        (2.0, "train", "step", {"step": 4}),
    ],
    "train-recovery": [
        (0.0, "train", "step", {"step": 1, "seconds": 0.5}),
        (0.6, "checkpoint", "save", {"step": 1, "save_kind": "full"}),
        (2.0, "precursor", "step_time_drift", {"host": 0, "risk": 1.0}),
        (2.1, "checkpoint", "proactive", {"step": 7, "reason": "r"}),
        (3.0, "sdc", "corruption", {"step": 10, "tier": "scrub"}),
        (3.2, "checkpoint", "restore", {"step": 7, "restore_s": 0.2}),
        (3.3, "train", "resume", {"step": 7, "rolled_back_from": 10}),
        (4.0, "train", "interrupted", {"step": 11}),
        (4.5, "heartbeat", "failure", {"host": 0}),
        (4.6, "train", "interrupted", {"step": 11}),
        (4.7, "heartbeat", "rejoin", {"host": 0}),
        (5.0, "train", "resume", {"step": 0, "scratch": True}),
        (6.0, "train", "step", {"step": 12}),
    ],
    "empty": [],
}


def _both(name):
    rows = TIMELINES[name]
    return ([_ev(R, t, s, k, **d) for t, s, k, d in rows],
            [_ev(P, t, s, k, **d) for t, s, k, d in rows])


@pytest.mark.parametrize("name", sorted(TIMELINES))
def test_timeline_summary_and_incidents_match(name):
    ref_evs, port_evs = _both(name)
    ref = R.Timeline.from_events(ref_evs)
    port = P.Timeline.from_events(port_evs)
    assert port.summary() == ref.summary()
    assert [i.to_dict() for i in port.incidents] == \
        [i.to_dict() for i in ref.incidents]
    assert [i.phase_offsets_ms() for i in port.incidents] == \
        [i.phase_offsets_ms() for i in ref.incidents]
    assert (port.mttr(), port.mtbf(), port.downtime(),
            port.availability()) == (ref.mttr(), ref.mtbf(),
                                     ref.downtime(), ref.availability())


@pytest.mark.parametrize("name", sorted(TIMELINES))
def test_chrome_trace_is_identical(name, tmp_path):
    ref_evs, port_evs = _both(name)
    trace = P.to_chrome_trace(port_evs)
    assert trace == R.to_chrome_trace(ref_evs)
    P.write_chrome_trace(str(tmp_path / "p.json"), port_evs)
    R.write_chrome_trace(str(tmp_path / "r.json"), ref_evs)
    assert open(tmp_path / "p.json").read() == \
        open(tmp_path / "r.json").read()


def test_derived_scenario_from_detections_matches():
    rows = [
        (0.0, "train", "step", {"step": 0}),
        (0.5, "heartbeat", "failure", {"host": 1,
                                       "detection_latency_s": 0.2}),
        (0.6, "heartbeat", "failure", {"host": 1}),
        (1.0, "serve", "replica_failed", {"replica": 3, "hosts": [3]}),
        (2.0, "heartbeat", "rejoin", {"host": 1}),
        (2.1, "injector", "bitflip", {"step": 5, "leaf": "params.w",
                                      "bit": 3}),
        (2.6, "injector", "bitflip", {"step": 6, "leaf": "params.v",
                                      "bit": 9}),
    ]
    ref = R.to_scenario([_ev(R, t, s, k, **d) for t, s, k, d in rows])
    port = P.to_scenario([_ev(P, t, s, k, **d) for t, s, k, d in rows])
    assert port.to_dict() == ref.to_dict()
    assert port.clock == "time" and port.name == "derived-replay"
    assert [e.kind for e in port.sorted_events()] == [
        "kill_hosts", "kill_hosts", "rejoin", "sdc_storm"]


def _recorded_chaos_events(sc):
    """The ``chaos/*`` events the reference's training driver records for
    ``sc`` (its compile step), as dicts."""
    from repro.chaos import TrainScenarioDriver

    class _E:
        send_filter = None

        def pause(self):
            pass

        def resume(self):
            pass

    obs = R.Observability()
    TrainScenarioDriver(sc, emitters={h: _E() for h in range(4)},
                        leaf_names=["params.w"], settle_seconds=0, obs=obs)
    return [e.to_dict() for e in obs.events()]


@pytest.mark.parametrize("case", ["compound", "storm", "partition"])
def test_declarative_scenario_round_trip_matches(case, tmp_path):
    from repro.chaos import Scenario as RScenario
    sc = {
        "compound": lambda: (RScenario("compound", clock="step", seed=42)
                             .kill_hosts([2, 3], at=6)
                             .sdc_storm(rate=0.3, window=(4, 10))
                             .traffic_spike(mult=4, window=(3, 12))
                             .rejoin(2, at=16).rejoin(3, at=16)),
        "storm": lambda: (RScenario("storm", seed=7)
                          .precursor_storm(1, 3.0, window=(2, 6))
                          .preempt(9)),
        "partition": lambda: (RScenario("part", seed=1)
                              .partition([[0, 1], [2]], at=2, heal_at=5)
                              .straggle(3, 2.0, window=(1, 4))),
    }[case]()
    recorded = _recorded_chaos_events(sc)
    port = P.to_scenario([P.Event.from_dict(d) for d in recorded])
    ref = R.to_scenario([R.Event.from_dict(d) for d in recorded])
    assert port.to_dict() == ref.to_dict() == sc.to_dict()
    # through a JSONL log on disk
    path = str(tmp_path / "events.jsonl")
    with open(path, "w") as f:
        for d in recorded:
            f.write(json.dumps(d) + "\n")
    assert P.to_scenario(P.load_jsonl(path)).to_dict() == sc.to_dict()
    assert P.to_scenario(P.load_jsonl(path), name="x").name == "x"


# ---------------------------------------------------------------------------
# the Observability bundle
# ---------------------------------------------------------------------------

def _drive(obs):
    obs.emit("train", "step", step=1, seconds=0.5, loss=3.0)
    obs.emit("heartbeat", "failure", host=2)
    obs.emit("checkpoint", "restore", step=0, restore_s=0.25, skipped=[])
    obs.emit("elastic", "resume", step=4)
    obs.registry.counter("heartbeat.failures").inc()
    obs.registry.histogram("train.step_ms").observe(500.0)


def test_snapshot_and_dump_bundle_match_the_reference(tmp_path, fixed_clock):
    bundles = {}
    for name, pkg in (("ref", R), ("port", P)):
        obs = pkg.Observability(capacity=100)
        _drive(obs)
        bundles[name] = (obs.snapshot(), obs.dump(str(tmp_path / name)))
        # a second dump with the (back-filled) sink attached reuses it
        obs.emit("s", "more")
        assert obs.dump(str(tmp_path / name))["events"] == \
            bundles[name][1]["events"]
        obs.close()
    (rsnap, rpaths), (psnap, ppaths) = bundles["ref"], bundles["port"]
    assert psnap == rsnap
    assert psnap["events"] == {"retained": 4, "emitted": 4, "dropped": 0}
    assert psnap["timeline"]["incidents"] == 1
    assert sorted(ppaths) == sorted(rpaths) == [
        "events", "metrics_json", "metrics_prom", "trace"]
    for key in ppaths:
        assert open(ppaths[key]).read() == open(rpaths[key]).read(), key
    assert len(P.load_jsonl(ppaths["events"])) == 5


def test_observability_sink_and_timed_tally(tmp_path):
    path = str(tmp_path / "t" / "events.jsonl")
    obs = P.Observability(jsonl_path=path)
    assert obs.host_seconds == 0.0
    with obs.timed():
        obs.emit("train", "step", step=1, seconds=0.1)
    assert obs.host_seconds > 0
    obs.bus.flush()
    assert P.load_jsonl(path) == obs.events()
    assert obs.to_scenario().to_dict()["events"] == []
    obs.close()
    obs.close()                                   # idempotent


# ---------------------------------------------------------------------------
# the facade and the BSP loop with telemetry attached
# ---------------------------------------------------------------------------

def _toy_port():
    state = {"step": torch.tensor(0), "w": torch.ones(2048)}

    class Data:
        def next_batch(self):
            return torch.ones(4)

    def train_step(state, batch):
        w = state["w"] + 0.01
        return ({"step": state["step"] + 1, "w": w},
                {"loss": torch.sum(w)})

    return state, Data(), train_step


def _toy_ref():
    import jax.numpy as jnp
    state = {"step": jnp.array(0), "w": jnp.ones((2048,))}

    class Data:
        def next_batch(self):
            return jnp.ones((4,))

    def train_step(state, batch):
        w = state["w"] + 0.01
        return ({"step": state["step"] + 1, "w": w},
                {"loss": float(jnp.sum(w))})

    return state, Data(), train_step


def _recover(pkg_core, obs, toy, tmp_path, *, failstop=(), bitflip=None,
             every_n=2, **config):
    dep = pkg_core.Dependability(pkg_core.DependabilityConfig(
        checkpoint_dir=str(tmp_path), policy_mode="every_n",
        every_n=every_n, signal_detection=False, fsync="none", **config))
    dep.attach_obs(obs)
    dep.start()
    state, data, step = toy
    dep.register_global_state(state)
    inj = pkg_core.FaultInjector(obs=obs)
    for s in failstop:
        inj.schedule_failstop(s)
    if bitflip is not None:
        inj.schedule_bitflip(*bitflip)
    _, info = pkg_core.run_with_recovery(dep, step, state, data, 8,
                                         fault_injector=inj)
    dep.stop()
    return dep, info


def _shape(obs):
    """(subsystem, kind, payload keys) of every event, in order."""
    return [(e.subsystem, e.kind, sorted(e.data)) for e in obs.events()]


@pytest.mark.parametrize("case", ["failstop", "scratch", "scrub"])
def test_recovery_emits_the_reference_events(tmp_path, case):
    import repro.core as RC
    import repro_torch.core as PC
    kw = {"failstop": dict(failstop=(4,)),
          "scratch": dict(failstop=(1,), every_n=100),
          "scrub": dict(bitflip=(5, "w", 30), scrub=True,
                        scrub_fraction=1.0)}[case]
    runs = {}
    for name, core, pkg, toy in (("ref", RC, R, _toy_ref()),
                                 ("port", PC, P, _toy_port())):
        obs = pkg.Observability()
        dep, info = _recover(core, obs, toy, tmp_path / name, **kw)
        runs[name] = (obs, dep, info)
    (robs, rdep, rinfo), (pobs, pdep, pinfo) = runs["ref"], runs["port"]
    assert _shape(pobs) == _shape(robs)
    assert pinfo["restarts"] == rinfo["restarts"] == 1
    for kind in ("interrupted", "resume"):
        assert [e.data for e in pobs.events("train", kind)] == \
            [e.data for e in robs.events("train", kind)]
    assert [e.data for e in pobs.events("sdc")] == \
        [e.data for e in robs.events("sdc")]
    # the save's measured seconds differ, and its bytes by the manifest's
    # few bytes of text
    timed = ("critical_path_s", "bytes")
    assert [{k: v for k, v in e.data.items() if k not in timed}
            for e in pobs.events("checkpoint", "save")] == \
        [{k: v for k, v in e.data.items() if k not in timed}
         for e in robs.events("checkpoint", "save")]
    assert all(e.data["bytes"] > 0
               for e in pobs.events("checkpoint", "save"))
    rsnap, psnap = robs.registry.snapshot(), pobs.registry.snapshot()
    assert sorted(psnap) == sorted(rsnap)
    for key, val in rsnap.items():
        if isinstance(val, dict):
            assert psnap[key]["count"] == val["count"], key
        elif key == "checkpoint.bytes":
            assert psnap[key] > 0
        else:
            assert psnap[key] == val, key
    assert P.Timeline.from_events(pobs.events()).summary()["incidents"] == \
        R.Timeline.from_events(robs.events()).summary()["incidents"]


def test_restore_feeds_the_measured_terms_into_the_policy(tmp_path):
    import repro_torch.core as PC
    from repro.core.policy import CheckpointPolicy as RPolicy
    obs = P.Observability()
    dep = PC.Dependability(PC.DependabilityConfig(
        checkpoint_dir=str(tmp_path), signal_detection=False, fsync="none"))
    dep.start()
    dep.attach_obs(obs)                # after start: still wired
    state, _, _ = _toy_port()
    dep.save(3, state)
    dep.monitor = types.SimpleNamespace(detection_latency={1: 0.4, 2: 0.9},
                                        any_failure=lambda: False)
    _, got = dep.restore_latest(like=state)
    dep.monitor = None
    ref = RPolicy()
    ref.observe_recovery(restart_s=dep.restore_seconds[-1], downtime_s=0.9)
    assert got == 3
    assert dep.policy.system.restart_seconds == ref.system.restart_seconds
    assert dep.policy.system.downtime_seconds == ref.system.downtime_seconds
    assert dep.policy.system.restart_seconds < 120.0
    (ev,) = obs.events("checkpoint", "restore")
    assert ev.data == {"step": 3, "restore_s": dep.restore_seconds[-1],
                       "skipped": []}
    assert obs.registry.counter("checkpoint.restores").value == 1
    assert obs.registry.histogram("checkpoint.restore_ms").count == 1
    dep.stop()


def test_attach_obs_reaches_the_heartbeat_monitor(tmp_path):
    import repro_torch.core as PC
    for before_start in (True, False):
        obs = P.Observability()
        dep = PC.Dependability(PC.DependabilityConfig(
            checkpoint_dir=str(tmp_path), signal_detection=False,
            heartbeat=True, heartbeat_period=0.05))
        if before_start:
            dep.attach_obs(obs)
        dep.start()
        if not before_start:
            assert dep.attach_obs(obs) is dep
        try:
            assert dep.monitor.obs is obs and dep.obs is obs
        finally:
            dep.stop()
