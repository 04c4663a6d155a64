"""Tier-2 SDC detection: the rotating state scrubber (the reference's
``sdc/scrubber.py``).

Training state only changes legitimately inside ``train_step``; between the
end of one superstep and the start of the next, every leaf should be
bit-identical.  The scrubber exploits that window: ``record(state, step)``
checksums a rotating subset of leaves right after the update, and
``verify(state)`` recomputes those checksums just before the next update
consumes the state — any difference is memory corruption, pinpointed to
the leaf.  With ``fraction=f`` each call checksums ceil(f * num_leaves)
leaves, so a full-state scrub is amortized over 1/f steps (f=1 covers
every leaf every step).

The scrubber is windowed, not historical: only the most recent record is
verifiable, because older baselines predate legitimate updates.  Coverage
is therefore probabilistic for f < 1 — a flip in an un-scrubbed leaf rides
until the tier-3 sentinel (or an ABFT matmul) notices its effect.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from repro_torch.sdc.checksum import checksums, named_leaves


class StateScrubber:
    def __init__(self, fraction: float = 0.25):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        self.fraction = fraction
        self._cursor = 0
        self._window: Dict[str, int] = {}    # leaf name -> checksum
        self._window_step: Optional[int] = None
        self.leaves_scrubbed = 0             # cumulative
        self.mismatches: List[str] = []      # every leaf ever flagged

    # ------------------------------------------------------------------
    def _subset(self, names: List[str]) -> List[str]:
        n = len(names)
        k = max(1, math.ceil(n * self.fraction))
        picked = [names[(self._cursor + i) % n] for i in range(min(k, n))]
        self._cursor = (self._cursor + k) % n
        return picked

    def record(self, state, step: int) -> List[str]:
        """Checksum the next rotation subset of ``state``; returns the
        covered leaf names.  Call right after the state is produced."""
        leaves = dict(named_leaves(state))
        subset = self._subset(sorted(leaves))
        self._window = dict(zip(subset, checksums([leaves[n]
                                                   for n in subset])))
        self._window_step = step
        self.leaves_scrubbed += len(subset)
        return subset

    def verify(self, state) -> List[str]:
        """Re-checksum the recorded window against ``state``; returns the
        names of corrupted leaves (empty = clean).  Call before the next
        update consumes the state."""
        if not self._window:
            return []
        leaves = dict(named_leaves(state))
        names = [n for n in self._window if n in leaves]
        got = checksums([leaves[n] for n in names])
        bad = [n for n, g in zip(names, got) if g != self._window[n]]
        self.mismatches.extend(bad)
        return bad

    def full_checksums(self, state) -> Dict[str, int]:
        """Checksum every leaf (save-time verification / debugging)."""
        named = named_leaves(state)
        return dict(zip((n for n, _ in named),
                        checksums([v for _, v in named])))

    def rebase(self, state) -> None:
        """Checksum the recorded window's leaves anew from ``state``: the
        same values held in another layout (the elastic loop's restore of
        the pause's state onto a new mesh, each rank its own shards), so
        a flip before the next update is still caught."""
        if not self._window:
            return
        leaves = dict(named_leaves(state))
        names = [n for n in self._window if n in leaves]
        self._window = dict(zip(names, checksums([leaves[n]
                                                  for n in names])))

    def reset(self) -> None:
        """Drop the window (call after a rollback: the restored state is a
        different set of buffers than the recorded one)."""
        self._window = {}
        self._window_step = None
