"""Checkpoint-interval policies: fixed interval and Young/Daly (paper eq. 1).

The reference's ``core/policy.py``, unchanged: it is plain Python.

    T_FO = sqrt(2 (mu - D + R) C)

with mu = system MTBF (per-node MTBF / node count), D = downtime, R =
recovery time, C = checkpoint cost.

The bracket's sign convention is a documented discrepancy: the paper
prints eq. (1) as ``mu - D + R`` (formula="paper", followed verbatim by
default), while the standard Young/Daly derivation subtracts BOTH the
downtime and the recovery time from the failure-free window —
``mu - D - R`` (formula="standard").  The standard bracket is never
larger, so it yields an equal-or-shorter period (checkpoints at least as
often).  For realistic fleets mu >> D + R and the two differ by well
under a percent; both are clamped at a small positive floor.

The adaptive policy estimates C online (EMA of measured save cost) and
converts the optimal period into a step interval using the measured step
time — this is the paper's "ajuste fino" the FWI experiment skipped (it
checkpointed every iteration, giving the max-overhead bound of eq. 3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


FORMULAS = ("paper", "standard")


def young_daly_period(mtbf_seconds: float, checkpoint_cost_s: float,
                      restart_s: float = 0.0, downtime_s: float = 0.0,
                      formula: str = "paper") -> float:
    """Paper eq. (1).  Clamps the bracket at a small positive floor.

    formula="paper": bracket = mu - D + R, as the paper prints it.
    formula="standard": bracket = mu - D - R, the textbook Young/Daly
    convention (see module docstring for the discrepancy).
    """
    if formula not in FORMULAS:
        raise ValueError(f"formula {formula!r} not in {FORMULAS}")
    sign = 1.0 if formula == "paper" else -1.0
    bracket = max(mtbf_seconds - downtime_s + sign * restart_s, 1e-9)
    return math.sqrt(2.0 * bracket * checkpoint_cost_s)


@dataclasses.dataclass
class SystemModel:
    """Fleet reliability model used to size the checkpoint interval."""
    node_mtbf_seconds: float = 3.15e7   # ~1 failure/node/year
    num_nodes: int = 1
    restart_seconds: float = 120.0
    downtime_seconds: float = 60.0

    @property
    def system_mtbf(self) -> float:
        return self.node_mtbf_seconds / max(self.num_nodes, 1)


class CheckpointPolicy:
    """Decides when to checkpoint.

    mode="every_n": fixed interval (paper's FWI setting used n=1).
    mode="young_daly": adaptive interval from eq. (1) with online C/step-time
    estimates.
    mode="risk_adjusted": young_daly, but the telemetry plane's per-host
    risk score (``observe_risk``, fed by the anomaly detectors —
    docs/observability.md "Telemetry plane") deflates the effective MTBF
    by ``(1 + risk_gain * risk)``: eq. (1) with the *conditional* failure
    rate given the precursors we are currently seeing, so the interval
    contracts ahead of a predicted failure and relaxes back as risk
    decays.  With risk 0 it is exactly young_daly.
    """

    def __init__(self, mode: str = "young_daly", every_n: int = 1,
                 system: Optional[SystemModel] = None, ema: float = 0.7,
                 min_interval: int = 1, max_interval: int = 100_000,
                 formula: str = "paper", risk_gain: float = 8.0):
        assert mode in ("every_n", "young_daly", "risk_adjusted"), mode
        assert formula in FORMULAS, formula
        self.mode = mode
        self.formula = formula
        self.every_n = max(int(every_n), 1)
        self.system = system or SystemModel()
        self.risk_gain = float(risk_gain)
        self.risk = 0.0                  # latest telemetry risk in [0, 1]
        self._ema = ema
        self.step_time_s: Optional[float] = None
        self.ckpt_cost_s: Optional[float] = None
        # per-kind cost tracking (delta checkpointing makes C bimodal:
        # cheap deltas + periodic expensive fulls; a single EMA whipsaws)
        self._kind_cost: dict = {}
        self._kind_count: dict = {}
        self.min_interval = min_interval
        self.max_interval = max_interval
        self._last_ckpt_step: Optional[int] = None

    # ---- online observations ----
    def observe_step(self, seconds: float) -> None:
        self.step_time_s = seconds if self.step_time_s is None else \
            self._ema * self.step_time_s + (1 - self._ema) * seconds

    def observe_checkpoint(self, seconds: float,
                           kind: Optional[str] = None) -> None:
        """Feed one measured checkpoint cost into the C estimate.

        ``kind=None``: single EMA (the legacy full-save pipeline).  With
        ``kind`` ("full"/"delta") each kind keeps its own EMA and C becomes
        the count-weighted mean across kinds — the AMORTIZED per-checkpoint
        cost eq. (1) actually pays under a full_every cadence, instead of
        an EMA that whipsaws between the two modes."""
        if kind is None:
            self.ckpt_cost_s = seconds if self.ckpt_cost_s is None else \
                self._ema * self.ckpt_cost_s + (1 - self._ema) * seconds
            return
        prev = self._kind_cost.get(kind)
        self._kind_cost[kind] = seconds if prev is None else \
            self._ema * prev + (1 - self._ema) * seconds
        self._kind_count[kind] = self._kind_count.get(kind, 0) + 1
        total = sum(self._kind_count.values())
        self.ckpt_cost_s = sum(
            self._kind_cost[k] * self._kind_count[k]
            for k in self._kind_cost) / total

    def observe_recovery(self, restart_s: Optional[float] = None,
                         downtime_s: Optional[float] = None) -> None:
        """Feed *measured* recovery terms into the system model: R from a
        timed restore (``Dependability.restore_latest``), D from the
        heartbeat monitor's last-beat -> declaration latency.  EMA with
        the same smoothing as C/step-time, so eq. (1)'s bracket tracks
        the deployment instead of trusting config estimates (the
        telemetry layer's live Young/Daly adaptation)."""
        if restart_s is not None:
            self.system.restart_seconds = (
                self._ema * self.system.restart_seconds
                + (1 - self._ema) * float(restart_s))
        if downtime_s is not None:
            self.system.downtime_seconds = (
                self._ema * self.system.downtime_seconds
                + (1 - self._ema) * float(downtime_s))

    def observe_risk(self, risk: float) -> None:
        """Feed the telemetry plane's current max per-host risk score
        (clamped to [0, 1]).  Only mode="risk_adjusted" consumes it."""
        self.risk = min(max(float(risk), 0.0), 1.0)

    # ---- decisions ----
    def interval_steps(self) -> int:
        if self.mode == "every_n":
            return self.every_n
        if not self.step_time_s or self.ckpt_cost_s is None:
            return self.min_interval  # bootstrap: measure C asap
        mtbf = self.system.system_mtbf
        if self.mode == "risk_adjusted" and self.risk > 0.0:
            # precursors say failures are (1 + gain*risk)x more likely
            # right now -> eq. (1) on the conditional MTBF
            mtbf /= (1.0 + self.risk_gain * self.risk)
        t_opt = young_daly_period(mtbf, self.ckpt_cost_s,
                                  self.system.restart_seconds,
                                  self.system.downtime_seconds,
                                  formula=self.formula)
        steps = int(round(t_opt / max(self.step_time_s, 1e-9)))
        return max(self.min_interval, min(steps, self.max_interval))

    def should_checkpoint(self, step: int) -> bool:
        if self._last_ckpt_step is None:
            due = step > 0 and step % self.interval_steps() == 0
        else:
            due = step - self._last_ckpt_step >= self.interval_steps()
        return due

    def record_checkpoint(self, step: int) -> None:
        self._last_ckpt_step = step

    # ---- paper metrics ----
    @staticmethod
    def fault_free_overhead(t_with: float, t_base: float) -> float:
        """Paper eq. (2)/(3): (M_with - M_without) / M_with."""
        return (t_with - t_base) / t_with
