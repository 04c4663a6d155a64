"""Slot-based cache pool: one cache row per in-flight request.

The pool holds ``num_slots`` independent rows of a stack's decode state
as the batch rows of one cache (``init_cache(cfg, num_slots,
cache_len, ...)``); the engine advances all of them in one batched
decode step.  The reference stacks B=1 rows on a new axis and vmaps the
step over it, so that each row carries its own ``index``/``pos``; here
each row carries them in the batch cache itself (``index`` (num_slots,),
an attention layer's ``pos`` (num_slots, sc)), and the decode step
(``models.transformer.forward``, mode ``decode``) writes and attends each
row at its own position.  A Mamba or RG-LRU layer's state has no
position: its row holds the conv state and the recurrent state ``h``
(float32), beside the attention layers' rows (a LOCAL layer's rolling
window).

Slot lifecycle (the reference's order): ``acquire`` hands the lowest free
slot to a request at prefill admission; the prefill runs against a FRESH
B=1 row and ``write_row`` copies the filled row into the slot, which also
overwrites whatever a previous occupant left there (stale ``pos``
entries from a longer earlier request would otherwise be attended once
the new request's position passes them); ``release`` recycles the slot
when the request completes or drains, ``release_all`` when the replica
dies.  Inactive slots keep decoding on stale state, their positions
running on past ``cache_len`` (the decode wraps their writes and clamps
their reads); their outputs are ignored.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.models.base import REC, SSM
from repro_torch.models.transformer import init_cache


class PoolExhausted(RuntimeError):
    """No free slot — admission control should have prevented this."""


class CachePool:
    """``cache_len``: the positions of an attention row (an SSM or RG-LRU
    layer's row has no sequence axis and ignores it)."""

    def __init__(self, cfg, num_slots: int, device, cache_len: int = 0):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if cache_len < 1 and any(k not in (SSM, REC)
                                 for k in cfg.layer_kinds()):
            raise ValueError(f"{cfg.name} has attention layers: its slot "
                             f"rows need cache_len >= 1, got {cache_len}")
        self.cfg = cfg
        self.num_slots = num_slots
        self.cache = init_cache(cfg, num_slots, cache_len, device)
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self._owner: Dict[int, int] = {}       # slot -> rid

    # ------------------------------------------------------------------
    # slot accounting
    # ------------------------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> List[int]:
        return sorted(self._owner)

    def owner(self, slot: int) -> Optional[int]:
        return self._owner.get(slot)

    def acquire(self, rid: int) -> int:
        if not self._free:
            raise PoolExhausted(
                f"all {self.num_slots} slots in use; admission control "
                "must gate on free_count")
        slot = self._free.pop()
        self._owner[slot] = rid
        return slot

    def release(self, slot: int) -> None:
        if slot not in self._owner:
            raise ValueError(f"slot {slot} not assigned")
        del self._owner[slot]
        self._free.append(slot)

    def release_all(self) -> List[int]:
        """Drain every slot (replica died); returns the rids that were in
        flight, in slot order (the engine requeues them in reverse so the
        queue front ends up back in slot order)."""
        rids = [self._owner[s] for s in sorted(self._owner)]
        self._owner.clear()
        self._free = list(range(self.num_slots - 1, -1, -1))
        return rids

    # ------------------------------------------------------------------
    # device cache
    # ------------------------------------------------------------------
    def write_row(self, slot: int, row_cache: Any) -> None:
        """Copy a filled B=1 cache (prefill output) into ``slot``, in
        place: every tensor of the row (k, v, pos, an SSM or RG-LRU
        layer's state, the position counter) is overwritten, so slot recycling never
        leaks a previous request's state."""
        for dst, src in zip(self.cache["layers"], row_cache["layers"]):
            for name, t in dst.items():
                t[slot].copy_(src[name][0])
        self.cache["index"][slot].copy_(row_cache["index"][0])
