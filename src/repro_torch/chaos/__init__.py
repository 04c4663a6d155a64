"""Chaos scenarios and the standing invariants every run is audited
against (docs/chaos.md), the part of the reference's ``chaos`` package
the telemetry plane needs: ``to_scenario`` builds a ``Scenario`` from a
recorded log, and ``check_detect_before_act`` audits the proactive
checkpoints and pre-drains.  The drivers that replay a scenario against
the training loop and the serving engine, and the control-plane
simulator, are ROADMAP item 11.
"""
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

__all__ = [
    "ChaosEvent", "InvariantResult", "InvariantViolation", "KINDS",
    "Scenario", "ScenarioError", "WINDOW_KINDS", "check_conservation",
    "check_detect_before_act", "check_monotonic_drain",
    "check_no_dead_growth", "check_no_lost_steps",
    "check_page_conservation", "check_token_identical",
    "check_trajectory_match", "check_zero_drop", "pass_rate", "summarize",
    "verify",
]
