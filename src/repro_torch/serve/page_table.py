"""Block-paged KV cache: free-page allocator, per-request page tables,
refcounted prefix cache.

A slot pool (``serve/cache_pool.py``) gives every in-flight request a
contiguous ``max_len`` cache row — concurrency is capped at
``num_slots`` and a short request wastes the whole row.  The paged pool
instead shares ONE device pool of ``num_pages`` pages of
``page_size`` tokens per attention layer (``models.init_paged_cache``,
stacked over layers as (L, P, ps, K, hd)); each request holds a *page table*
mapping its logical positions onto physical pages (logical position
``t`` -> page ``table[t // page_size]``, offset ``t % page_size``), and
one table serves every layer (all layers advance in lockstep).  Page 0
is the reserved null page: zeroed table entries of inactive rows point
at it, and the length mask keeps it out of every real softmax.

**Refcounts.**  ``refs[p]`` counts the holders of physical page ``p`` —
rows whose table maps it, plus prefix-cache entries that pin it.  A page
is writable by a row only while the row is its sole holder
(``refs == 1``); ``ensure_writable`` copy-on-writes a shared page before
the row's next decode token lands in it.  A page returns to the free
list when its last holder lets go — ``release``/``release_all`` on the
row side, LRU eviction on the entry side — so a leak or double-free is
an accounting bug ``audit()`` catches.

**Prefix cache.**  After a miss prefill, the row's pages are registered
under the prompt's page-aligned prefixes: a later prompt sharing the
prefix attaches those pages read-only (refcounted) instead of
re-prefilling them, and an *exact* repeat of a full prompt also reuses
the stored first greedy token — the whole prefill is skipped and the
stream stays bit-identical because that token came from the original
prefill's own argmax, not a recomputation.

**Admission.**  ``can_admit`` gates on worst-case growth: a request
needs ``ceil((len(prompt) + max_new_tokens - 1) / page_size)`` pages if
it runs to its token budget, and the pool *reserves* the not-yet-
allocated tail (plus one page of copy-on-write allowance for an
unaligned shared tail) so a request admitted near capacity can never
hit ``PageExhausted`` mid-decode (the failure mode the slot pool's
``free_count`` gating could not express).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import init_paged_cache

DEFAULT_PAGE_SIZE = 16


class PageExhausted(RuntimeError):
    """No free page — reservation accounting should have prevented this;
    the engine treats it as a planned requeue, not an incident."""


# ---------------------------------------------------------------------------
# device ops: in-place tensor copies into the pool
# ---------------------------------------------------------------------------

@torch.no_grad()
def _write_pages(pages, row, page_ids, start_page: int) -> None:
    """Scatter a filled B=1 prefill row (``init_cache`` layout, with
    ``pos``) into physical pages ``page_ids`` covering logical pages
    ``start_page..start_page+n-1``, in place.  Rolling LOCAL rows only
    retain the last ``window`` positions; the ``pos``-match writes zeros
    for positions the row no longer holds (or never held) — the window
    and length masks exclude exactly those at read time."""
    dev = pages["k"].device
    ids = torch.as_tensor(page_ids, dtype=torch.long, device=dev)
    ps = pages["k"].shape[2]
    t = ((start_page + torch.arange(len(page_ids), device=dev))[:, None]
         * ps + torch.arange(ps, device=dev)[None, :])          # (n, ps)
    for li, entry in enumerate(row["layers"]):
        src = t % entry["k"].shape[1]
        valid = (entry["pos"][0][src] == t)[..., None, None]
        for name in ("k", "v"):
            vals = torch.where(valid, entry[name][0][src],
                               torch.zeros((), dtype=entry[name].dtype,
                                           device=dev))
            pages[name][li][ids] = vals.to(pages[name].dtype)


@torch.no_grad()
def _copy_page(pages, src: int, dst: int) -> None:
    """Copy-on-write: duplicate physical page ``src`` into ``dst`` in
    every layer's pool, in place."""
    for name in ("k", "v"):
        pages[name][:, dst] = pages[name][:, src]


# ---------------------------------------------------------------------------
# host-side accounting
# ---------------------------------------------------------------------------

@dataclass
class PrefixEntry:
    """One cached prompt prefix: ``pages`` pinned read-only, covering
    ``ntok`` token positions.  ``first_token`` is set when the entry
    covers an ENTIRE prompt (the original prefill's greedy argmax) —
    an exact repeat skips prefill and still opens with the bit-identical
    token.  ``row_refs`` counts rows currently attached (an entry is
    evictable only at zero)."""
    key: bytes
    pages: Tuple[int, ...]
    ntok: int
    first_token: Optional[int] = None
    row_refs: int = 0


def _pkey(tokens) -> bytes:
    return np.asarray(list(tokens), np.int64).tobytes()


@dataclass
class AdmitPlan:
    """What ``acquire`` decided for one request (returned to the engine).

    ``shared``: prefix pages attached; ``new``: pages allocated now for
    the non-shared prompt tail; ``reserved``: pages reserved for decode
    growth + copy-on-write; ``skip_prefill`` + ``first_token``: exact
    full-prompt hit."""
    shared: int = 0
    new: int = 0
    reserved: int = 0
    skip_prefill: bool = False
    first_token: Optional[int] = None
    entry_key: Optional[bytes] = None
    write_ids: Tuple[int, ...] = field(default_factory=tuple)
    write_start: int = 0


class PagedKVCache:
    """The replica's KV pool: ``free_count`` / ``active_slots`` /
    ``owner`` / ``release`` / ``release_all`` (rows play the role of the
    slot pool's slots), plus the page-aware admission and prefix surface
    the engine drives.  ``page_tables`` and ``lengths`` are host-side
    numpy state, as in the reference; ``pages`` lives on ``device``."""

    def __init__(self, cfg, num_pages: int, page_size: int, cache_len: int,
                 max_active: int, prefix: bool = True, registry=None,
                 device=None):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is the null "
                             f"page), got {num_pages}")
        if cache_len % page_size:
            raise ValueError(f"cache_len {cache_len} not a multiple of "
                             f"page_size {page_size}")
        self.cfg = cfg
        self.num_pages = num_pages
        self.page_size = page_size
        self.cache_len = cache_len
        self.pages_per_row = cache_len // page_size
        self.max_active = max_active
        self.prefix_enabled = prefix
        self._registry = registry
        self.device = resolve_device(device)
        self.pages = init_paged_cache(cfg, num_pages, page_size,
                                      self.device)

        self._refs = np.zeros(num_pages, np.int64)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._rows_free: List[int] = list(range(max_active - 1, -1, -1))
        self._owner: Dict[int, int] = {}                 # row -> rid
        self._row_entry: Dict[int, bytes] = {}           # row -> prefix key
        self._row_reserved: Dict[int, int] = {}
        self._reserved_total = 0
        self._pending_write: Dict[int, Tuple[Tuple[int, ...], int]] = {}
        self._prefix: "OrderedDict[bytes, PrefixEntry]" = OrderedDict()
        self.page_tables = np.zeros((max_active, self.pages_per_row),
                                    np.int32)
        self.lengths = np.zeros((max_active,), np.int32)
        # observability (docs/observability.md): pressure + sharing
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.pages_allocated = 0
        self.cow_copies = 0
        self.last_drain: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------
    # accounting views
    # ------------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def free_count(self) -> int:                         # CachePool compat
        return len(self._rows_free)

    @property
    def active_slots(self) -> List[int]:
        return sorted(self._owner)

    def owner(self, row: int) -> Optional[int]:
        return self._owner.get(row)

    def available(self) -> int:
        """Pages free AND not spoken for by another row's growth
        reservation."""
        return len(self._free) - self._reserved_total

    def _needed(self, plen: int, max_new: int) -> int:
        return -(-(plen + max_new - 1) // self.page_size)

    # ------------------------------------------------------------------
    # prefix probe
    # ------------------------------------------------------------------
    def _probe(self, prompt, max_new: int) -> AdmitPlan:
        ps = self.page_size
        L = len(prompt)
        prompt_pages = -(-L // ps)
        total = self._needed(L, max_new)
        plan = AdmitPlan()
        if self.prefix_enabled:
            e = self._prefix.get(_pkey(prompt))
            if e is not None and e.first_token is not None:
                plan.shared = len(e.pages)
                plan.skip_prefill = True
                plan.first_token = e.first_token
                plan.entry_key = e.key
            else:
                for m in range(L // ps, 0, -1):
                    e = self._prefix.get(_pkey(prompt[:m * ps]))
                    if e is not None and e.ntok == m * ps:
                        plan.shared = m
                        plan.entry_key = e.key
                        break
        plan.new = prompt_pages - plan.shared
        # growth reservation: the unallocated decode tail, plus one page
        # of copy-on-write allowance when the first decode write can land
        # in a page the prefix cache holds (unaligned prompt tail)
        cow = 1 if (self.prefix_enabled and max_new >= 2 and L % ps) else 0
        plan.reserved = (total - prompt_pages) + cow
        return plan

    def can_admit(self, prompt, max_new: int) -> bool:
        if not self._rows_free:
            return False
        plan = self._probe(prompt, max_new)
        need = plan.new + plan.reserved
        return need <= self.available() + self._reclaimable()

    def _reclaimable(self) -> int:
        """Pages LRU eviction could free right now: pages held only by
        zero-``row_refs`` prefix entries (conservative — a page pinned by
        two idle entries counts zero until one of them goes)."""
        n = 0
        for e in self._prefix.values():
            if e.row_refs == 0:
                n += sum(1 for p in e.pages if self._refs[p] == 1)
        return n

    def _evict_until(self, need: int, keep: Optional[bytes] = None) -> None:
        while self.available() < need:
            victim = next((k for k, e in self._prefix.items()
                           if e.row_refs == 0 and k != keep), None)
            if victim is None:
                break
            self._drop_entry(victim)

    def _drop_entry(self, key: bytes) -> None:
        e = self._prefix.pop(key)
        for p in e.pages:
            self._unref(p)

    def _unref(self, p: int) -> None:
        self._refs[p] -= 1
        if self._refs[p] == 0:
            self._free.append(p)
        assert self._refs[p] >= 0, f"double-free of page {p}"

    def _alloc(self) -> int:
        if not self._free:
            raise PageExhausted(
                f"all {self.num_pages - 1} pages held "
                f"({self._reserved_total} reserved)")
        p = self._free.pop()
        self._refs[p] = 1
        self.pages_allocated += 1
        return p

    # ------------------------------------------------------------------
    # row lifecycle
    # ------------------------------------------------------------------
    def acquire(self, rid: int, prompt, max_new: int
                ) -> Tuple[int, AdmitPlan]:
        """Admit one request: attach shared prefix pages, allocate pages
        for the non-shared prompt tail, reserve worst-case decode growth.
        Returns (row, plan); call ``write_prefill`` + ``register_prefix``
        after the prefill (unless ``plan.skip_prefill``)."""
        if not self._rows_free:
            raise PageExhausted("no free row; gate on can_admit")
        plan = self._probe(prompt, max_new)
        self._evict_until(plan.new + plan.reserved, keep=plan.entry_key)
        if plan.new + plan.reserved > self.available():
            raise PageExhausted(
                f"need {plan.new}+{plan.reserved} pages, "
                f"{self.available()} available; gate on can_admit")
        row = self._rows_free.pop()
        self._owner[row] = rid
        L = len(prompt)
        table = self.page_tables[row]
        table[:] = 0
        if plan.entry_key is not None:
            e = self._prefix[plan.entry_key]
            e.row_refs += 1
            self._prefix.move_to_end(plan.entry_key)     # LRU touch
            self._row_entry[row] = plan.entry_key
            for j, p in enumerate(e.pages[:plan.shared]):
                table[j] = p
                self._refs[p] += 1
            self.prefix_hits += 1
        else:
            self.prefix_misses += 1
        new_ids = []
        for j in range(plan.shared, plan.shared + plan.new):
            p = self._alloc()
            table[j] = p
            new_ids.append(p)
        plan.write_ids = tuple(new_ids)
        plan.write_start = plan.shared
        self._pending_write[row] = (plan.write_ids, plan.write_start)
        self._row_reserved[row] = plan.reserved
        self._reserved_total += plan.reserved
        self.lengths[row] = L
        if self._registry is not None:
            self._registry.histogram("serve.page_alloc").observe(plan.new)
        return row, plan

    def write_prefill(self, row: int, row_cache: Any) -> None:
        """Scatter the prefill's B=1 cache row into the pages allocated at
        ``acquire`` (shared prefix pages are never rewritten)."""
        ids, start = self._pending_write.pop(row, ((), 0))
        if not ids:
            return
        _write_pages(self.pages, row_cache, ids, start)

    def register_prefix(self, row: int, prompt, first_token: int) -> None:
        """Pin this row's prompt pages in the prefix cache: the aligned
        prefix for cross-prompt sharing, and — for an unaligned prompt —
        the full prompt with its first greedy token for exact-repeat
        prefill skips.  (An aligned prompt's full entry IS its aligned
        entry; the stored first token upgrades it in place.)"""
        if not self.prefix_enabled:
            return
        ps = self.page_size
        L = len(prompt)
        table = self.page_tables[row]
        m = L // ps
        if m > 0:
            key = _pkey(prompt[:m * ps])
            e = self._prefix.get(key)
            if e is None:
                pages = tuple(int(p) for p in table[:m])
                e = PrefixEntry(key, pages, m * ps,
                                first_token=(int(first_token)
                                             if m * ps == L else None))
                for p in pages:
                    self._refs[p] += 1
                self._prefix[key] = e
            elif m * ps == L and e.first_token is None:
                e.first_token = int(first_token)
        if L % ps:
            key = _pkey(prompt)
            if key not in self._prefix:
                pages = tuple(int(p) for p in table[:-(-L // ps)])
                e = PrefixEntry(key, pages, L, first_token=int(first_token))
                for p in pages:
                    self._refs[p] += 1
                self._prefix[key] = e

    def ensure_writable(self, row: int) -> Optional[str]:
        """Make the page under this row's next decode write exclusively
        owned: allocate it if the table still points at the null page
        (growth into the reservation), copy-on-write it if the prefix
        cache or a sharer also holds it.  Returns "grow", "cow", or None.
        Raises ``PageExhausted`` only if admission accounting was
        bypassed — the engine requeues the stream as a planned drain."""
        pos = int(self.lengths[row])
        pi = pos // self.page_size
        if pi >= self.pages_per_row:
            raise PageExhausted(
                f"row {row} at position {pos} past its {self.pages_per_row}"
                f"-page table")
        table = self.page_tables[row]
        phys = int(table[pi])
        if phys == 0:
            self._consume_reservation(row)
            table[pi] = self._alloc()
            return "grow"
        if self._refs[phys] > 1:
            self._consume_reservation(row)
            new = self._alloc()
            _copy_page(self.pages, phys, new)
            self._refs[phys] -= 1                 # row lets the shared go
            table[pi] = new
            self.cow_copies += 1
            return "cow"
        return None

    def _consume_reservation(self, row: int) -> None:
        left = self._row_reserved.get(row, 0)
        if left > 0:
            self._row_reserved[row] = left - 1
            self._reserved_total -= 1

    def advance(self, row: int) -> None:
        self.lengths[row] += 1

    def release(self, row: int) -> int:
        """Give back every page this row holds (shared pages just drop a
        ref) and its unused reservation; returns the rid."""
        if row not in self._owner:
            raise ValueError(f"row {row} not assigned")
        rid = self._owner.pop(row)
        for j in range(self.pages_per_row):
            p = int(self.page_tables[row, j])
            if p:
                self._unref(p)
        self.page_tables[row] = 0
        self.lengths[row] = 0
        self._reserved_total -= self._row_reserved.pop(row, 0)
        self._pending_write.pop(row, None)
        key = self._row_entry.pop(row, None)
        if key is not None and key in self._prefix:
            self._prefix[key].row_refs -= 1
        self._rows_free.append(row)
        return rid

    def release_all(self) -> List[int]:
        """Drain every row (replica died): returns the in-flight rids in
        row order — the CachePool contract the router/engine requeue walk
        depends on.  The drained page tables and prefix refcounts become
        part of the drain record (``last_drain``): every page — including
        shared-prefix refs — returns to the free list, and ``audit()``
        must come back clean (no leak, no double-free).  The prefix cache
        dies with the replica: its pages lived in THIS pool's device
        memory."""
        rows = sorted(self._owner)
        report = {"rows": [
            {"rid": self._owner[r], "row": r, "len": int(self.lengths[r]),
             "pages": [int(p) for p in self.page_tables[r] if p],
             "reserved": self._row_reserved.get(r, 0)}
            for r in rows],
            "prefix_entries": len(self._prefix)}
        rids = [self.release(r) for r in rows]
        for key in list(self._prefix):
            self._drop_entry(key)
        report["pages_freed"] = self.num_pages - 1
        self.last_drain = report
        ok, detail = self.audit()
        assert ok, f"page leak after release_all: {detail}"
        assert len(self._free) == self.num_pages - 1, \
            f"{self.num_pages - 1 - len(self._free)} pages leaked in drain"
        return rids

    # ------------------------------------------------------------------
    # invariants
    # ------------------------------------------------------------------
    def audit(self) -> Tuple[bool, str]:
        """Recompute refcounts from the ground truth (row tables + prefix
        entries) and check page conservation.  A mismatch is a leak or
        double-free."""
        want = np.zeros(self.num_pages, np.int64)
        for row in self._owner:
            for p in self.page_tables[row]:
                if p:
                    want[int(p)] += 1
        for e in self._prefix.values():
            for p in e.pages:
                want[p] += 1
        if not np.array_equal(want[1:], self._refs[1:]):
            bad = np.nonzero(want[1:] != self._refs[1:])[0][:8] + 1
            return False, (f"refcount drift at pages {bad.tolist()}: "
                           f"have {self._refs[bad].tolist()}, "
                           f"want {want[bad].tolist()}")
        held = int(np.count_nonzero(self._refs[1:]))
        if held + len(self._free) != self.num_pages - 1:
            return False, (f"{held} held + {len(self._free)} free != "
                           f"{self.num_pages - 1} pages")
        if len(set(self._free)) != len(self._free):
            return False, "free list holds duplicates"
        if self._reserved_total != sum(self._row_reserved.values()):
            return False, (f"reserved_total {self._reserved_total} != "
                           f"sum of row reservations")
        if self._reserved_total > len(self._free):
            return False, (f"{self._reserved_total} pages reserved but "
                           f"only {len(self._free)} free")
        return True, (f"{held} held, {len(self._free)} free, "
                      f"{self._reserved_total} reserved")

    def conservation(self) -> Dict[str, int]:
        """One page-accounting sample for the chaos invariant suite."""
        ok, _ = self.audit()
        return {"pages_total": self.num_pages - 1,
                "pages_free": len(self._free),
                "pages_held": self.num_pages - 1 - len(self._free),
                "pages_reserved": self._reserved_total,
                "refs_ok": int(ok)}


__all__ = ["PagedKVCache", "PageExhausted", "AdmitPlan", "PrefixEntry",
           "DEFAULT_PAGE_SIZE"]
