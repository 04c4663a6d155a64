"""Tier-3 SDC detection: the end-to-end loss sentinel.

The cheapest guard with the widest net: corruption anywhere in params,
optimizer state, or activations that materially changes the computation
eventually shows up in the loss.  The sentinel checks each superstep's
metrics for (a) non-finite loss / grad-norm — the device-side flag from
train/step.py rolls both into one scalar — and (b) a loss spike versus a
running EMA.  It has no ability to localize (that is what tiers 1-2 are
for) but catches what they miss, including flips in un-scrubbed leaves.

The EMA only absorbs healthy observations: a tripping value never updates
it, so the baseline survives the anomaly and rollback-replayed steps are
judged against the pre-corruption level.
"""
from __future__ import annotations

import math
from typing import Optional


class LossSentinel:
    def __init__(self, spike_factor: float = 10.0, ema: float = 0.9,
                 warmup: int = 5):
        self.spike_factor = spike_factor
        self.ema = ema
        self.warmup = warmup
        self.loss_ema: Optional[float] = None
        self.observed = 0
        self.trips = 0

    def observe(self, step: int, loss: float,
                grad_norm: Optional[float] = None,
                nonfinite: Optional[float] = None) -> Optional[str]:
        """Feed one superstep's metrics; returns a reason string when the
        step looks corrupted, else None (and the EMA absorbs the value)."""
        reason = None
        if nonfinite is not None and nonfinite > 0:
            reason = f"non-finite loss/grad at step {step}"
        elif not math.isfinite(loss):
            reason = f"non-finite loss {loss!r} at step {step}"
        elif grad_norm is not None and not math.isfinite(grad_norm):
            reason = f"non-finite grad norm {grad_norm!r} at step {step}"
        elif (self.observed >= self.warmup and self.loss_ema is not None
                and loss > self.spike_factor * max(self.loss_ema, 1e-12)):
            reason = (f"loss spike at step {step}: {loss:.4g} > "
                      f"{self.spike_factor:g} x EMA {self.loss_ema:.4g}")
        if reason is not None:
            self.trips += 1
            return reason
        self.loss_ema = (loss if self.loss_ema is None
                         else self.ema * self.loss_ema + (1 - self.ema) * loss)
        self.observed += 1
        return None
