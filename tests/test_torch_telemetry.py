"""The port's telemetry plane on the CPU against the JAX package's
(``repro.obs``, ``repro.chaos``, ``repro.core.policy``, the reference's
``ServeEngine``): one input, the same decisions.

- the wire: ``Collector`` (inc, seq) acceptance, gap accounting, counter
  deltas and gauges, and the skew-merged timeline against the single-host
  oracle, on datagrams with explicit stamps; ``TelemetryAgent``'s
  datagrams and its bounded buffer; one agent -> collector run over real
  UDP on 127.0.0.1 with a bounded poll;
- the detectors and ``AnomalyEngine``: score and risk trajectories and
  the precursor events over one event sequence;
- ``make_proactive_hook``'s reasons and cooldown, ``risk_adjusted``
  intervals, and ``run_bsp``'s forced saves (the cadence-wins case too);
- the chaos schema: every canned scenario, ``precursor_storm``'s round
  trip and validation, and the invariants, ``check_detect_before_act``'s
  four cases among them;
- serving: a tiny float32 ``ServeEngine`` pre-drains the risky replica
  (never the last healthy one) with the reference's streams, 0 dropped;
- both CLIs with their telemetry flags.
"""
import glob
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.chaos as RC
import repro.obs as R
import repro_torch.chaos as PC
import repro_torch.obs as P
from repro.core.policy import CheckpointPolicy as RPolicy
from repro.core.policy import SystemModel as RSystem
from repro_torch.core.policy import CheckpointPolicy as PPolicy
from repro_torch.core.policy import SystemModel as PSystem

ROOT = Path(__file__).resolve().parents[1]
SCENARIOS = sorted(glob.glob(str(ROOT / "scenarios" / "*.json")))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dgram(host, seq, t_send, events=(), inc=1.0, **extra):
    return {"host": host, "inc": inc, "seq": seq, "t_send": t_send,
            "events": list(events), **extra}


def _wire(t_mono, subsystem="train", kind="step", **data):
    return {"seq": 0, "t_mono": t_mono, "t_wall": 0.0,
            "subsystem": subsystem, "kind": kind, **data}


def _flat(events):
    return [(e.t_mono, e.subsystem, e.kind, e.data) for e in events]


class _Collectors:
    """One collector of each package; every call goes to both."""

    def __enter__(self):
        self.ref, self.port = R.Collector(), P.Collector()
        return self

    def ingest(self, payload, t_recv):
        got = (self.ref.ingest(dict(payload), t_recv=t_recv),
               self.port.ingest(dict(payload), t_recv=t_recv))
        assert got[0] == got[1]
        return got[1]

    def __exit__(self, *exc):
        self.ref.stop()
        self.port.stop()


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def test_collector_acceptance_and_gap_accounting_match():
    with _Collectors() as c:
        assert c.ingest(_dgram(1, 0, 10.0), 10.1)
        assert not c.ingest(_dgram(1, 0, 10.0), 10.2)      # duplicate
        assert c.ingest(_dgram(1, 1, 10.5), 10.6)
        assert c.ingest(_dgram(1, 4, 11.0), 11.1)           # 2 lost
        assert not c.ingest(_dgram(1, 9, 12.0, inc=0.5), 12.1)
        assert c.ingest(_dgram(1, 0, 12.5, inc=2.0), 12.6)  # restarted
        assert c.port.gap_report() == c.ref.gap_report() == {
            1: {"datagrams": 4, "missed": 2, "stale": 2}}
        assert _flat(c.port.events()) == _flat(c.ref.events())
        (gap,) = c.port.events("telemetry", "gap")
        assert gap.data == {"origin": 1, "missed_datagrams": 2,
                            "after_seq": 1}


def test_collector_counter_deltas_and_gauge_last_values_match():
    with _Collectors() as c:
        c.ingest(_dgram(3, 0, 1.0, counters={"tok": 5.0},
                        gauges={"queue": 2.0}), 1.1)
        c.ingest(_dgram(3, 1, 2.0, counters={"tok": 2.5},
                        gauges={"queue": 7.0}), 2.1)
        c.ingest(_dgram(4, 0, 2.0, gauges={"queue": 1.0}), 2.2)
        assert c.port.host_metrics() == c.ref.host_metrics() == {
            3: {"counters": {"tok": 7.5}, "gauges": {"queue": 7.0}},
            4: {"counters": {}, "gauges": {"queue": 1.0}}}
        assert c.port.risk_scores() == {} and c.port.risk(3) == 0.0


def test_skew_merged_timeline_matches_the_single_host_oracle():
    """Two hosts with opposite clock skews (+40 s, -25 s) and a lost
    window of host 2's datagrams: the merged stream is gap-annotated,
    keeps each host's emit order, lives in the collector's clock domain,
    and its MTTR equals the one computed on host 1's own events — in
    both packages, event for event."""
    host1 = [P.Event(seq=i, t_mono=100.0 + t, t_wall=0.0, subsystem=s,
                     kind=k, data=d) for i, (t, s, k, d) in enumerate([
                         (0.00, "heartbeat", "failure", {"host": 1}),
                         (0.05, "checkpoint", "restore", {"step": 6}),
                         (0.12, "train", "resume", {"step": 7})])]
    host2 = [P.Event(seq=i, t_mono=100.0 + 0.01 * i, t_wall=0.0,
                     subsystem="train", kind="step", data={"step": i})
             for i in range(6)]
    shipped = {1: [], 2: []}
    for host, evs, skew in ((1, host1, 40.0), (2, host2, -25.0)):
        ag = P.TelemetryAgent(host, ("127.0.0.1", 9), P.EventBus(),
                              skew_seconds=skew, chunk=1,
                              send_filter=lambda h, p: shipped[h].append(p)
                              or False)
        for ev in evs:
            ag._on_event(ev)
        ag.flush()
        ag._sock.close()
    oracle = P.Timeline.from_events(host1).mttr()
    assert oracle == pytest.approx(0.12)
    with _Collectors() as c:
        for k, p in enumerate(shipped[1]):
            c.ingest(dict(p, t_send=140.0 + 0.05 * k), 100.2 + 0.05 * k)
        for k, p in enumerate(shipped[2]):
            if 2 <= p["seq"] <= 3:
                continue                                  # lost
            c.ingest(dict(p, t_send=75.0 + 0.01 * k), 100.3 + 0.01 * k)
        merged = c.port.events()
        assert _flat(merged) == _flat(c.ref.events())
        assert P.Timeline.from_events(merged).mttr() == oracle
        assert R.Timeline.from_events(c.ref.events()).mttr() == oracle
        for host in (1, 2):
            steps = [e.data["step"] for e in merged
                     if e.data.get("origin") == host and "step" in e.data]
            assert steps == sorted(steps)
        gaps = c.port.events("telemetry", "gap")
        assert len(gaps) == 1 and gaps[0].data["origin"] == 2
        assert gaps[0].data["missed_datagrams"] == 2
        assert max(e.t_mono for e in merged) - \
            min(e.t_mono for e in merged) < 1.0
        assert c.port.timeline().summary() == c.ref.timeline().summary()


def test_agent_datagrams_match_the_reference():
    """Same events and metrics into both agents: the same datagram
    payloads (counter deltas, gauge values, chunking, metrics on the first
    chunk only), apart from each agent's incarnation and send stamp."""
    got = {}
    for name, pkg in (("ref", R), ("port", P)):
        reg = pkg.MetricsRegistry()
        sent = []
        ag = pkg.TelemetryAgent(5, ("127.0.0.1", 9), pkg.EventBus(),
                                registry=reg, chunk=2,
                                send_filter=lambda h, p: sent.append(p)
                                or False)
        reg.counter("tokens").inc(9)
        reg.gauge("queue").set(3)
        for i in range(5):
            ag._on_event(pkg.Event(seq=i, t_mono=1.0 + i, t_wall=0.0,
                                   subsystem="train", kind="step",
                                   data={"step": i}))
        assert ag.flush() == 0                       # all filtered
        reg.counter("tokens").inc(1)
        ag.flush()
        assert ag.flush() == 0 and ag.sent_datagrams == 0
        ag._sock.close()
        got[name] = [{k: v for k, v in p.items() if k not in ("inc",
                                                              "t_send")}
                     for p in sent]
    assert got["port"] == got["ref"]
    # 5 events in chunks of 2, then a delta, then the gauges alone
    assert [p["seq"] for p in got["port"]] == [0, 1, 2, 3, 4]
    assert [len(p["events"]) for p in got["port"]] == [2, 2, 1, 0, 0]
    assert [p.get("counters") for p in got["port"]] == [
        {"tokens": 9.0}, None, None, {"tokens": 1.0}, {}]
    assert got["port"][4]["gauges"] == {"queue": 3.0}


def test_agent_buffer_sheds_oldest_under_backpressure():
    sheds = []
    for pkg in (R, P):
        bus = pkg.EventBus()
        ag = pkg.TelemetryAgent(0, ("127.0.0.1", 9), bus, buffer_cap=4,
                                send_filter=lambda h, p: False)
        bus.subscribe(ag._on_event)
        for i in range(10):
            bus.emit("a", "x", step=i)
        sheds.append((ag.shed, [d["step"] for d in ag._buf]))
        ag._sock.close()
    assert sheds[0] == sheds[1] == (6, [6, 7, 8, 9])


def test_agent_and_collector_over_real_udp():
    """The socket path end to end: the agent's thread ships a live bus to
    a listening collector on 127.0.0.1 (both on port 0); the test polls
    with a deadline instead of sleeping a fixed time."""
    anomaly = P.AnomalyEngine()
    col = P.Collector(anomaly=anomaly).start()
    bus = P.EventBus()
    reg = P.MetricsRegistry()
    reg.counter("tokens").inc(9)
    ag = P.TelemetryAgent(0, col.addr, bus, registry=reg,
                          period=0.02).start()

    def wait_for(pred, seconds=10.0):
        deadline = time.monotonic() + seconds
        while not pred() and time.monotonic() < deadline:
            time.sleep(0.01)
        return pred()

    try:
        for i in range(5):
            bus.emit("train", "step", step=i, seconds=0.01)
        assert wait_for(lambda: len(col.events("train", "step")) == 5)
        got = col.events("train", "step")
        assert [e.data["step"] for e in got] == [0, 1, 2, 3, 4]
        assert all(e.data["origin"] == 0 for e in got)
        assert wait_for(lambda: col.host_metrics().get(0, {})
                        .get("counters") == {"tokens": 9.0})
        assert col.gap_report()[0]["missed"] == 0
    finally:
        ag.stop()
        col.stop()
    assert ag._thread is None and col._thread is None


# ---------------------------------------------------------------------------
# detectors and the risk fold
# ---------------------------------------------------------------------------

def _step_evs(pkg, seconds, hosts=None, subsystem="train", kind="step"):
    out = []
    for i, s in enumerate(seconds):
        data = {"seconds": s}
        if hosts is not None:
            data["host"] = hosts[i]
        out.append(pkg.Event(seq=i, t_mono=float(i), t_wall=0.0,
                             subsystem=subsystem, kind=kind, data=data))
    return out


DRIFT = [0.01] * 5 + [0.05] * 7 + [0.011, 0.012] + [0.2, 0.3, 0.009, 0.4]


@pytest.mark.parametrize("factor,consecutive,warmup,alpha", [
    (2.0, 3, 3, 0.2), (2.0, 1, 2, 0.5), (1.5, 2, 0, 0.2), (4.0, 1, 5, 0.1)])
def test_drift_detector_scores_match(factor, consecutive, warmup, alpha):
    hosts = [i % 2 for i in range(len(DRIFT))]
    dets = [pkg.StepTimeDriftDetector(factor=factor,
                                      consecutive=consecutive,
                                      warmup=warmup, alpha=alpha)
            for pkg in (R, P)]
    for subsystem, kind in (("train", "step"), ("telemetry", "replica_step"),
                            ("serve", "step")):
        scores = [[d.observe(7, e) for e in _step_evs(pkg, DRIFT, hosts,
                                                      subsystem, kind)]
                  for d, pkg in zip(dets, (R, P))]
        assert scores[0] == scores[1]
    assert dets[1]._mean == dets[0]._mean
    with pytest.raises(ValueError):
        P.StepTimeDriftDetector(factor=1.0)


def test_jitter_and_scrub_detectors_match():
    arrivals = np.cumsum([0.05] * 6 + [0.3, 0.3, 0.05, 0.4, 0.5, 0.05])
    js = [pkg.BeatJitterDetector(factor=3.0, consecutive=2, warmup=3)
          for pkg in (R, P)]
    assert [js[0].observe_arrival(1, float(t)) for t in arrivals] == \
        [js[1].observe_arrival(1, float(t)) for t in arrivals]
    assert any(js[1].observe_arrival(1, float(t)) is not None
               for t in arrivals[-1] + np.cumsum([2.0, 2.0, 2.0]))
    hits = [0.0, 1.0, 2.0, 3.0, 30.0, 31.0, 100.0, 120.0, 140.0]
    ss = []
    for pkg in (R, P):
        det = pkg.ScrubRateDetector(window=3, max_span=10.0)
        ss.append([det.observe(0, pkg.Event(
            seq=0, t_mono=t, t_wall=0.0, subsystem="sdc", kind="corruption",
            data={"host": 2})) for t in hits])
    assert ss[0] == ss[1] and ss[1][2] is not None


def _engine_run(pkg, events):
    fired, emitted = [], []
    eng = pkg.AnomalyEngine(
        detectors=[pkg.StepTimeDriftDetector(factor=2.0, consecutive=2,
                                             warmup=2),
                   pkg.ScrubRateDetector(window=2, max_span=5.0)],
        decay=0.5, on_precursor=lambda h, k, r: fired.append((h, k, r)),
        emit=lambda *a, **kw: emitted.append((a, kw)))
    risks = []
    for origin, e in events:
        eng.observe_event(origin, e)
        risks.append(eng.risk_scores())
    return risks, fired, emitted, eng.precursors


def test_anomaly_engine_risk_trajectory_matches():
    rows = ([(4, 0.01)] * 3 + [(4, 0.08)] * 2 + [(4, 0.01)] * 3
            + [(5, 0.02)] * 3 + [(5, 0.09)] * 2)
    runs = []
    for pkg in (R, P):
        evs = [(o, e) for (o, _), e in
               zip(rows, _step_evs(pkg, [s for _, s in rows]))]
        evs.insert(6, (4, pkg.Event(seq=0, t_mono=6.0, t_wall=0.0,
                                    subsystem="sdc", kind="corruption",
                                    data={})))
        evs.insert(7, (4, pkg.Event(seq=0, t_mono=7.0, t_wall=0.0,
                                    subsystem="sdc", kind="corruption",
                                    data={})))
        evs.append((4, pkg.Event(seq=0, t_mono=0.0, t_wall=0.0,
                                 subsystem="precursor",
                                 kind="step_time_drift",
                                 data={"host": 4, "seconds": 9.0})))
        runs.append(_engine_run(pkg, evs))
    assert runs[0] == runs[1]
    risks, fired, emitted, n = runs[1]
    assert n == len(fired) == len(emitted) >= 3
    assert {h for h, _, _ in fired} == {4, 5}
    assert {k for _, k, _ in fired} == {"step_time_drift", "scrub_rate"}


def test_anomaly_engine_attach_emits_precursors_onto_the_bus():
    out = []
    for pkg in (R, P):
        bus = pkg.EventBus()
        eng = pkg.AnomalyEngine(detectors=[pkg.StepTimeDriftDetector(
            factor=2.0, consecutive=1, warmup=2)])
        eng.attach(bus, origin=3)
        for s in (0.01, 0.01, 0.01, 0.09, 0.01):
            bus.emit("train", "step", seconds=s)
        out.append(([(e.kind, e.data) for e in bus.events("precursor")],
                    eng.risk_scores()))
    assert out[0] == out[1]
    assert out[1][0] == [("step_time_drift",
                          {"host": 3, "score": 1.0, "risk": 1.0})]


def test_collector_with_anomaly_engine_feeds_risk():
    risks = []
    for pkg in (R, P):
        col = pkg.Collector(anomaly=pkg.AnomalyEngine(
            detectors=[pkg.StepTimeDriftDetector(factor=2.0, consecutive=1,
                                                 warmup=2)]))
        try:
            for i, s in enumerate([0.01, 0.01, 0.01, 0.5]):
                col.ingest(_dgram(2, i, float(i), [_wire(float(i),
                                                         seconds=s)]),
                           t_recv=float(i) + 0.1)
            risks.append((col.risk_scores(), col.risk(2),
                          [e.data["host"] for e in
                           col.events("precursor")]))
        finally:
            col.stop()
    assert risks[0] == risks[1] == ({2: 1.0}, 1.0, [2])


def test_make_proactive_hook_reasons_cooldown_and_policy_feed():
    scores = {}
    schedule = {2: {3: 0.9}, 4: {3: 0.9}, 7: {3: 0.9}, 19: {},
                30: {1: 0.6, 2: 0.8}, 31: {1: 0.4}, 40: {}}
    out = []
    for pkg, pol in ((R, RPolicy), (P, PPolicy)):
        policy = pol(mode="risk_adjusted")
        hook = pkg.make_proactive_hook(lambda: dict(scores), threshold=0.5,
                                       cooldown_steps=5, policy=policy)
        trail = []
        for step in range(1, 42):
            if step in schedule:
                scores.clear()
                scores.update(schedule[step])
            trail.append((hook(step), policy.risk))
        out.append(trail)
    assert out[0] == out[1]
    reasons = [(i + 1, r) for i, (r, _) in enumerate(out[1]) if r]
    assert reasons == [(2, "risk:3:0.90"), (7, "risk:3:0.90"),
                       (12, "risk:3:0.90"), (17, "risk:3:0.90"),
                       (30, "risk:2:0.80")]
    assert out[1][3][1] == pytest.approx(0.9)     # fed through cooldown


@pytest.mark.parametrize("risk", [0.0, 0.1, 0.25, 0.5, 1.0, 50.0, -3.0])
def test_risk_adjusted_intervals_match(risk):
    def make(pol, sysm, mode):
        p = pol(mode=mode, system=sysm(node_mtbf_seconds=3600.0,
                                       num_nodes=1, restart_seconds=1.0,
                                       downtime_seconds=1.0))
        p.observe_step(1.0)
        p.observe_checkpoint(2.0)
        return p
    ref = make(RPolicy, RSystem, "risk_adjusted")
    port = make(PPolicy, PSystem, "risk_adjusted")
    yd = make(PPolicy, PSystem, "young_daly")
    for p in (ref, port, yd):
        p.observe_risk(risk)
    assert port.risk == ref.risk
    assert port.interval_steps() == ref.interval_steps()
    if port.risk > 0:
        assert port.interval_steps() < yd.interval_steps()
    else:
        assert port.interval_steps() == yd.interval_steps()


# ---------------------------------------------------------------------------
# run_bsp's proactive hook
# ---------------------------------------------------------------------------

def _bsp(tmp_path, every_n, hook, steps=8):
    from repro_torch.core import Dependability, DependabilityConfig, run_bsp
    dep = Dependability(DependabilityConfig(
        checkpoint_dir=str(tmp_path), policy_mode="every_n",
        every_n=every_n, signal_detection=False, fsync="none"))
    obs = P.Observability()
    dep.attach_obs(obs)
    dep.start()
    state = {"step": torch.tensor(0), "w": torch.ones(4)}
    dep.register_global_state(state)

    class Data:
        def next_batch(self):
            return torch.ones(4)

    def train_step(state, batch):
        return ({"step": state["step"] + 1, "w": state["w"] + 0.01},
                {"loss": torch.tensor(1.0)})

    _, status, hist = run_bsp(dep, train_step, state, Data(), steps,
                              proactive=hook, final_save=False)
    dep.stop()
    return dep, obs, status, hist


def test_run_bsp_proactive_hook_forces_save_and_emits(tmp_path):
    calls = []

    def hook(step):
        calls.append(step)
        return "risk:0:0.90" if step == 5 else None

    dep, obs, status, hist = _bsp(tmp_path, 100, hook)
    assert status == "done" and len(hist) == 8
    assert calls == list(range(1, 9))
    assert [s.step for s in dep.save_history] == [5]
    (pro,) = obs.events("checkpoint", "proactive")
    assert pro.data == {"step": 5, "reason": "risk:0:0.90"}
    assert obs.registry.counter("checkpoint.proactive").value == 1
    assert dep.policy._last_ckpt_step == 5
    steps = obs.events("train", "step")
    assert [e.data["step"] for e in steps] == list(range(1, 9))
    assert sorted(steps[0].data) == ["loss", "seconds", "step", "straggler"]
    assert obs.registry.histogram("train.step_ms").count == 8
    assert obs.host_seconds > 0


def test_run_bsp_cadence_save_wins_over_proactive(tmp_path):
    """On a step the cadence saves at, the hook is not polled: no double
    save, no forced-save event."""
    polled = []
    dep, obs, status, _ = _bsp(tmp_path, 2, polled.append, steps=6)
    assert status == "done"
    assert polled == [1, 3, 5]
    assert [s.step for s in dep.save_history] == [2, 4, 6]
    assert obs.events("checkpoint", "proactive") == []


def test_run_bsp_interruption_without_final_save(tmp_path):
    from repro_torch.core import Dependability, DependabilityConfig, run_bsp
    for final_save, saves in ((False, []), (True, [0])):
        dep = Dependability(DependabilityConfig(
            checkpoint_dir=str(tmp_path / str(final_save)),
            policy_mode="every_n", every_n=100, signal_detection=False,
            fsync="none")).start()
        dep.interrupted = lambda: True
        state = {"step": torch.tensor(0), "w": torch.ones(4)}
        _, status, _ = run_bsp(dep, None, state, None, 4,
                               final_save=final_save)
        assert status == "interrupted"
        assert [s.step for s in dep.save_history] == saves
        dep.stop()


# ---------------------------------------------------------------------------
# the chaos schema and the invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", SCENARIOS, ids=os.path.basename)
def test_canned_scenarios_load_identically(path):
    port, ref = PC.Scenario.from_json(path), RC.Scenario.from_json(path)
    assert port.to_dict() == ref.to_dict()
    assert port.horizon == ref.horizon
    assert PC.Scenario.from_json(port.to_json()).to_dict() == port.to_dict()
    assert repr(port) == repr(ref)


def test_precursor_storm_round_trip_and_validation(tmp_path):
    path = str(ROOT / "scenarios" / "precursor_storm.json")
    sc = PC.Scenario.from_json(path)
    (storm,) = sc.window_events("precursor_storm")
    assert storm.args["kill"] is True and storm.args["factor"] > 1
    out = str(tmp_path / "s.json")
    sc.to_json(out)
    assert PC.Scenario.from_json(out).to_dict() == \
        RC.Scenario.from_json(out).to_dict() == sc.to_dict()
    # the storm's kill at its window end pairs with a later rejoin
    ok = PC.Scenario("x").precursor_storm(1, 3.0, window=(2, 6)) \
        .rejoin(1, at=8).validate()
    assert [e.kind for e in ok.sorted_events()] == ["precursor_storm",
                                                    "rejoin"]


BAD_SCENARIOS = [
    {"events": [{"kind": "nope", "at": 1}]},
    {"events": [{"kind": "kill_hosts", "hosts": [1], "at": -1}]},
    {"events": [{"kind": "rejoin", "host": 1, "at": 3}]},
    {"events": [{"kind": "kill_hosts", "hosts": [1], "at": 1},
                {"kind": "kill_hosts", "hosts": [1], "at": 2}]},
    {"events": [{"kind": "precursor_storm", "host": 1, "factor": 0.5,
                 "window": [1, 4]}]},
    {"events": [{"kind": "precursor_storm", "host": 1, "factor": 2.0,
                 "window": [1, 4]},
                {"kind": "kill_hosts", "hosts": [1], "at": 5}]},
    {"events": [{"kind": "sdc_storm", "rate": 2.0, "window": [0, 3]}]},
    {"events": [{"kind": "partition", "groups": [[0, 1], [1]], "at": 1,
                 "heal_at": 2}]},
    {"events": [{"kind": "straggle", "host": 1, "factor": 2.0}]},
    {"events": [{"kind": "preempt", "at": 1, "sig": "USR1"}]},
    {"events": [{"kind": "traffic_spike", "mult": 2, "window": [0, 1],
                 "extra": 1}]},
    {"clock": "wall", "events": []},
]


@pytest.mark.parametrize("d", BAD_SCENARIOS)
def test_scenario_validation_errors_match(d):
    msgs = []
    for pkg in (RC, PC):
        with pytest.raises(pkg.ScenarioError) as err:
            pkg.Scenario.from_dict(d)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert issubclass(PC.ScenarioError, ValueError)


def _mk(pkg, t, subsystem, kind, **data):
    return pkg.Event(seq=int(t * 1000), t_mono=t, t_wall=0.0,
                     subsystem=subsystem, kind=kind, data=data)


DBA_CASES = {
    "ordered": ([(1.0, "train", "step", {"step": 1}),
                 (2.0, "precursor", "step_time_drift", {"host": 2,
                                                        "risk": 1.0}),
                 (3.0, "checkpoint", "proactive", {"step": 6}),
                 (4.0, "serve", "replica_predrained", {"replica": 0,
                                                       "hosts": [2]}),
                 (5.0, "heartbeat", "failure", {"host": 2})], True),
    "no-precursor": ([(1.0, "checkpoint", "proactive", {"step": 3})],
                     False),
    "act-first": ([(1.0, "checkpoint", "proactive", {"step": 3}),
                   (2.0, "precursor", "step_time_drift", {"host": 0,
                                                          "risk": 1.0})],
                  False),
    "unpredicted-failure": ([
        (1.0, "heartbeat", "failure", {"host": 2}),
        (2.0, "precursor", "step_time_drift", {"host": 2, "risk": 1.0}),
        (3.0, "checkpoint", "proactive", {"step": 6})], False),
    "serve-failure-before": ([
        (1.0, "serve", "replica_failed", {"replica": 1, "hosts": [4]}),
        (2.0, "precursor", "step_time_drift", {"host": 4, "risk": 0.9})],
        False),
}


@pytest.mark.parametrize("case", sorted(DBA_CASES))
def test_check_detect_before_act_matches(case):
    rows, want = DBA_CASES[case]
    got = [pkg.check_detect_before_act(
        [_mk(ev, t, s, k, **d) for t, s, k, d in rows])
        for pkg, ev in ((RC, R), (PC, P))]
    assert got[0].passed == got[1].passed == want
    assert (got[1].name, got[1].detail) == (got[0].name, got[0].detail)


class _Req:
    def __init__(self, state):
        self.state = state


class _Sched:
    def __init__(self, states, failed=()):
        self.requests = {i: _Req(s) for i, s in enumerate(states)}
        self.failed_rids = list(failed)


INVARIANT_CASES = [
    ("check_zero_drop", (_Sched(["DONE", "DONE"]),)),
    ("check_zero_drop", (_Sched(["DONE", "DECODE"]),)),
    ("check_zero_drop", (_Sched(["DONE"], failed=[0]),)),
    ("check_zero_drop", (_Sched(["DONE"]), [0, 5])),
    ("check_token_identical", ({1: [3, 4]}, {1: [3, 4]})),
    ("check_token_identical", ({1: [3, 5]}, {1: [3, 4]})),
    ("check_token_identical", ({}, {1: [3, 4]})),
    ("check_trajectory_match", ([1.0, 2.0], [1.0, 2.1])),
    ("check_trajectory_match", ([1.0, 2.0], [1.0, 2.0], 0)),
    ("check_trajectory_match", ([1.0], [1.0, 2.0])),
    ("check_no_lost_steps", ([{"step": 1, "loss": 1.0},
                              {"step": 2, "loss": 1.0}], 2)),
    ("check_no_lost_steps", ([{"step": 1, "loss": 1.0},
                              {"step": 1, "loss": 1.0}], 2)),
    ("check_no_dead_growth", ([(5.0, [2])], {2: [(1.0, 4.0)]})),
    ("check_no_dead_growth", ([(3.0, [2])], {2: [(1.0, float("inf"))]})),
    ("check_monotonic_drain", ([0, 1, 1, 3],)),
    ("check_monotonic_drain", ([0, 2, 1],)),
    ("check_conservation", ([{"submitted": 4, "completed": 1, "queued": 1,
                              "in_flight": 2}],)),
    ("check_conservation", ([{"submitted": 4, "completed": 1, "queued": 1,
                              "in_flight": 1, "rejected": 0}],)),
    ("check_page_conservation", ([{"pages_free": 3, "pages_held": 5,
                                   "pages_total": 8, "pages_reserved": 2,
                                   "refs_ok": 1}],)),
    ("check_page_conservation", ([{"pages_free": 3, "pages_held": 5,
                                   "pages_total": 8, "pages_reserved": 4,
                                   "refs_ok": 1}],)),
    ("check_page_conservation", ([],)),
]


@pytest.mark.parametrize("name,args", INVARIANT_CASES)
def test_invariants_match(name, args):
    ref, port = getattr(RC, name)(*args), getattr(PC, name)(*args)
    assert (port.name, port.passed, port.detail) == \
        (ref.name, ref.passed, ref.detail)


def test_verify_pass_rate_and_summarize_match():
    results = [(RC.InvariantResult(n, ok, d), PC.InvariantResult(n, ok, d))
               for n, ok, d in (("a", True, ""), ("b", False, "bad"),
                                ("c", True, "x"))]
    ref, port = [r for r, _ in results], [p for _, p in results]
    assert PC.pass_rate(port) == RC.pass_rate(ref) == pytest.approx(2 / 3)
    assert PC.pass_rate([]) == 1.0
    assert PC.summarize(port) == RC.summarize(ref)
    with pytest.raises(PC.InvariantViolation, match="b: bad"):
        PC.verify(port)
    assert PC.verify(port[:1]) == port[:1]
    assert set(PC.__all__) == set(RC.__all__)
    assert {"ControlPlaneSim", "ServeScenarioDriver",
            "TrainScenarioDriver"} <= set(PC.__all__)


# ---------------------------------------------------------------------------
# serving: pre-drain on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    import dataclasses

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


PROMPTS = [[3, 4, 5, 6], [7, 8, 9], [10, 11, 12, 13, 14], [15, 16, 17]]


def _predrain_run(engine_cls, cfg, params, risk, *, replicas=2,
                  standby=False, **kw):
    """Work lands on every replica at step 0; at step 1 the risk source
    names replica 1's host (``risk`` from then on)."""
    scores = {}
    eng = engine_cls(cfg, params, num_replicas=replicas,
                     slots_per_replica=2, max_len=24, page_size=4,
                     risk_source=lambda: dict(scores),
                     pre_drain_threshold=0.8, **kw)
    if standby:
        eng.add_standby(lambda: params)
    rids = [eng.submit(p, 8) for p in PROMPTS]
    eng.step()
    scores.update(risk(eng))
    res = eng.run()
    out = {"streams": [res[r] for r in rids],
           "dropped": list(eng.scheduler.failed_rids),
           "retried": sorted(eng.scheduler.retried_rids),
           "predrained": [(e.data["replica"], e.data["hosts"],
                           e.data["risk"], e.data["drained"])
                          for e in eng.obs.events("serve",
                                                  "replica_predrained")],
           "failed": eng.obs.events("serve", "replica_failed"),
           "healthy": sorted(r.id for r in eng.router.healthy()),
           "router_events": [(k, i) for k, i, _ in eng.router.events],
           "replica_steps": len(eng.obs.events("telemetry",
                                               "replica_step")),
           "counter": eng.obs.registry.counter(
               "serve.replica_predrains").value,
           "incidents": len(eng.obs.timeline().incidents)}
    eng.shutdown()
    return out


@pytest.mark.parametrize("case", ["two-replicas", "last-healthy",
                                  "standby"])
def test_engine_pre_drain_matches_the_reference(tiny, case):
    from repro.serve import ServeEngine as RServe
    from repro_torch.serve import ServeEngine as PServe
    jcfg, jparams, tcfg, tparams = tiny
    kw = {"two-replicas": dict(risk=lambda e: {e.router.replicas[1]
                                               .hosts[0]: 0.95}),
          "last-healthy": dict(risk=lambda e: {0: 1.0}, replicas=1),
          "standby": dict(risk=lambda e: {0: 0.9}, replicas=1,
                          standby=True)}[case]
    ref = _predrain_run(RServe, jcfg, jparams, **kw)
    port = _predrain_run(lambda *a, **k: PServe(*a, device="cpu", **k),
                         tcfg, tparams, **kw)
    assert port["streams"] == ref["streams"]
    for key in ("dropped", "retried", "predrained", "healthy",
                "router_events", "replica_steps", "counter", "incidents"):
        assert port[key] == ref[key], key
    assert port["dropped"] == [] and port["failed"] == []
    assert port["incidents"] == 0
    if case == "last-healthy":
        assert port["predrained"] == [] and port["healthy"] == [0]
    else:
        assert len(port["predrained"]) == 1 and port["retried"]


def test_engine_without_risk_source_emits_no_replica_steps(tiny):
    from repro_torch.serve import ServeEngine
    _, _, tcfg, tparams = tiny
    eng = ServeEngine(tcfg, tparams, device="cpu", num_replicas=2,
                      slots_per_replica=2, max_len=24, page_size=4)
    [eng.submit(p, 4) for p in PROMPTS]
    eng.run()
    assert eng.obs.events("telemetry") == []
    assert eng.risk_source is None and eng.pre_drain_threshold == 0.8
    rep = eng.router.replicas[1]
    assert eng.router.drain_replica(rep, "manual") == []   # idle: nothing
    assert not rep.healthy and rep.fail_reason == "predrain:manual"
    assert eng.router.drain_replica(rep, "again") == []    # idempotent
    eng.shutdown()


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _cli(module, args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module, "--tiny",
                           "--device", "cpu", *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("flags", [
    ["--telemetry-dir", "{d}/tele"],
    ["--metrics-snapshot", "{d}/m.json"],
    ["--telemetry-plane"],
    ["--proactive-checkpoint"],
    ["--policy", "risk_adjusted", "--telemetry-plane"],
    ["--policy", "risk_adjusted", "--proactive-checkpoint",
     "--telemetry-dir", "{d}/tele", "--metrics-snapshot", "{d}/m.json"],
])
def test_train_cli_telemetry_flags(tmp_path, flags):
    flags = [f.format(d=tmp_path) for f in flags]
    out = _cli("repro_torch.launch.train",
               ["--steps", "6", "--seq-len", "16", "--global-batch", "2",
                "--inject-failure", "4", "--ckpt-dir",
                str(tmp_path / "ckpt"), *flags])
    assert out.returncode == 0, out.stderr
    assert "[train] done in" in out.stdout and "restarts=1;" in out.stdout
    assert "[train] telemetry: " in out.stdout
    if "--telemetry-dir" in flags:
        tele = tmp_path / "tele"
        assert sorted(os.listdir(tele)) == ["events.jsonl", "metrics.json",
                                            "metrics.prom", "trace.json"]
        evs = P.load_jsonl(str(tele / "events.jsonl"))
        kinds = {(e.subsystem, e.kind) for e in evs}
        assert {("train", "step"), ("train", "interrupted"),
                ("train", "resume"), ("checkpoint", "restore")} <= kinds
        json.load(open(tele / "trace.json"))
    if "--metrics-snapshot" in flags:
        snap = json.load(open(tmp_path / "m.json"))
        assert snap["train.step_ms"]["count"] >= 6


def test_serve_cli_pre_drain_and_telemetry_dir(tmp_path):
    out = _cli("repro_torch.launch.serve",
               ["--replicas", "2", "--requests", "4", "--prompt-len", "8",
                "--gen", "6", "--pre-drain", "--risk-threshold", "0.9",
                "--telemetry-dir", str(tmp_path / "t"),
                "--metrics-snapshot", str(tmp_path / "m.json")])
    assert out.returncode == 0, out.stderr
    assert "served 4/4 requests" in out.stdout
    assert "telemetry: 0 incidents" in out.stdout
    evs = P.load_jsonl(str(tmp_path / "t" / "events.jsonl"))
    assert any(e.kind == "replica_step" for e in evs)
    assert "serve.tokens" in json.load(open(tmp_path / "m.json"))
