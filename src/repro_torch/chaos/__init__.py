"""Chaos scenario engine: trace-driven correlated-failure injection and a
cluster-scale control-plane simulator (docs/chaos.md; the reference's
``chaos`` package).

One declarative ``Scenario`` (timed kills, partitions, SDC storms,
stragglers, traffic spikes, rejoins) replays against three planes with the
same semantics: the elastic training loop on a rank mesh
(``run_scenario_elastic``), the serving engine (``ServeScenarioDriver``),
and a device-free simulator that validates the control-plane protocol at
thousands of virtual hosts (``ControlPlaneSim``).  ``invariants`` holds
the standing post-run checks every plane is audited against;
``repro_torch.obs.to_scenario`` builds a ``Scenario`` back from a
recorded log.
"""
from repro_torch.chaos.driver import (ServeScenarioDriver,
                                      TrainScenarioDriver,
                                      run_scenario_elastic)
from repro_torch.chaos.invariants import (InvariantResult,
                                          InvariantViolation,
                                          check_conservation,
                                          check_detect_before_act,
                                          check_monotonic_drain,
                                          check_no_dead_growth,
                                          check_no_lost_steps,
                                          check_page_conservation,
                                          check_token_identical,
                                          check_trajectory_match,
                                          check_zero_drop, pass_rate,
                                          summarize, verify)
from repro_torch.chaos.scenario import (KINDS, WINDOW_KINDS, ChaosEvent,
                                        Scenario, ScenarioError)
from repro_torch.chaos.sim import ControlPlaneSim, SimReport

__all__ = [
    "ChaosEvent", "ControlPlaneSim", "InvariantResult",
    "InvariantViolation", "KINDS", "Scenario", "ScenarioError",
    "ServeScenarioDriver", "SimReport", "TrainScenarioDriver",
    "WINDOW_KINDS", "check_conservation", "check_detect_before_act",
    "check_monotonic_drain", "check_no_dead_growth", "check_no_lost_steps",
    "check_page_conservation", "check_token_identical",
    "check_trajectory_match", "check_zero_drop", "pass_rate",
    "run_scenario_elastic", "summarize", "verify",
]
