"""Tier-3 SDC detection for the decode path: the logit sentinel.

Serving has no loss to watch, but it has the same end-to-end signal: the
logits every decode step produces.  Corruption on a replica — a flipped
bit in its params copy, a bad cache row, a broken MXU tile — shows up as
(a) non-finite logits, or (b) a softmax-entropy spike toward log(V): a
scrambled linear map sends inputs to near-noise, and noise logits are
near-uniform.  The sentinel is the serving sibling of ``LossSentinel``:
one observation per decode step per replica, an EMA baseline that only
absorbs healthy observations, and a reason string when a step trips.

It cannot localize which request's row is corrupt (the cache pool is one
tensor), so the router treats a trip as a REPLICA failure: exclude the
replica, drain its requests, re-execute them on survivors — greedy decode
makes the retried streams token-identical (docs/serving.md).
"""
from __future__ import annotations

import math
from typing import Optional


class DecodeSentinel:
    def __init__(self, spike_factor: float = 4.0, ema: float = 0.9,
                 warmup: int = 8, abs_max_entropy: Optional[float] = None):
        """``spike_factor``: trip when entropy > factor x EMA (after
        ``warmup`` healthy observations).  ``abs_max_entropy``: optional
        hard ceiling (e.g. 0.95 * log(vocab)) that trips even during
        warmup — a replica can come up corrupted."""
        self.spike_factor = spike_factor
        self.ema = ema
        self.warmup = warmup
        self.abs_max_entropy = abs_max_entropy
        self.entropy_ema: Optional[float] = None
        self.observed = 0
        self.trips = 0

    def observe(self, step: int, nonfinite: float,
                entropy: float) -> Optional[str]:
        """Feed one decode step's aggregated stats (max nonfinite flag and
        mean entropy over the ACTIVE rows); returns a trip reason or None
        (and the EMA absorbs the healthy value)."""
        reason = None
        if nonfinite > 0:
            reason = f"non-finite logits at decode step {step}"
        elif not math.isfinite(entropy):
            reason = f"non-finite entropy {entropy!r} at decode step {step}"
        elif (self.abs_max_entropy is not None
                and entropy > self.abs_max_entropy):
            reason = (f"entropy {entropy:.4g} above ceiling "
                      f"{self.abs_max_entropy:.4g} at decode step {step}")
        elif (self.observed >= self.warmup and self.entropy_ema is not None
                and entropy > self.spike_factor
                * max(self.entropy_ema, 1e-12)):
            reason = (f"entropy spike at decode step {step}: {entropy:.4g} "
                      f"> {self.spike_factor:g} x EMA {self.entropy_ema:.4g}")
        if reason is not None:
            self.trips += 1
            return reason
        self.entropy_ema = (entropy if self.entropy_ema is None
                            else self.ema * self.entropy_ema
                            + (1 - self.ema) * entropy)
        self.observed += 1
        return None

    def reset(self) -> None:
        """A replacement replica is a different set of buffers: start the
        baseline over."""
        self.entropy_ema = None
        self.observed = 0
