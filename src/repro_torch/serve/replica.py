"""One model replica: params + cache pool + the shared serve steps.

N replicas hold the same parameter tensors (one set on the card, as the
reference shares one pytree), each with its own pool, each emitting
heartbeats to the shared ``HeartbeatMonitor`` under its host ids.

Paged (attention stacks): prefill is B=1 against a fresh contiguous row,
run at one fixed length (the page-aligned ``cache_len``, see
``train.serve.make_prefill_step``), and the row's pages are scattered
into the ``PagedKVCache``.  Decode is ONE batched step over all
``max_active`` rows through their page tables.

Slot pool (``paged=False``; Mamba, RG-LRU and M-RoPE stacks always): prefill is B=1
against a fresh row, copied into a ``CachePool`` slot.  An attention
stack's rows hold ``cache_len`` positions (``max_len`` rounded up to a
whole number of ``DEFAULT_PAGE_SIZE`` pages) and its prefill runs at
that one length, the paged path's prefill shape, so that at equal decode
shapes the slot pool's streams equal the paged pool's bit for bit (the
reference's contract).  A stack with SSM or RG-LRU layers prefills at
the prompt's own length (padding would run through the recurrent state;
a retry re-prefills the same prompt at the same shape).  Decode is ONE batched
step over all ``num_slots`` rows, each at its own position.

An MoE stack prefills at the prompt's own length on either pool, as the
reference does: padding positions would route too, and the expert
capacity ``ceil(S k cf / E)`` grows with the padded S, so a padded
prefill would keep tokens the reference drops.

Warm standbys (``make_standby_source``) restore the parameters from the
newest checkpoint that verifies, through ``CheckpointManager``.

Either way every decode call has the same shapes whatever rows are live
— a row's tokens do not depend on which row it sits in or who shares the
batch.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.heartbeat import HeartbeatEmitter
from repro_torch.models import init_cache
from repro_torch.models.base import REC, SSM
from repro_torch.sdc import DecodeSentinel
from repro_torch.serve.cache_pool import CachePool
from repro_torch.serve.page_table import DEFAULT_PAGE_SIZE, PagedKVCache
from repro_torch.train import (make_paged_decode_step, make_prefill_step,
                               make_serve_decode_step)


class ServeFns:
    """Serve steps and pool geometry shared by every replica of one
    engine.  ``paged=True``: the pool is the reference's equal-memory
    default, the slot pool's budget of ``num_slots`` rows of ``max_len``
    tokens repaged into ``page_size``-token pages (+1 for the reserved
    null page).  ``paged=False``: a ``CachePool`` of ``num_slots`` rows
    of ``cache_len`` positions."""

    def __init__(self, cfg, num_slots: int, max_len: int, device,
                 paged: bool = True,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 num_pages: Optional[int] = None,
                 max_active: Optional[int] = None,
                 prefix_cache: bool = True):
        self.cfg = cfg
        self.device = device
        self.num_slots = num_slots
        self.max_len = max_len
        self.paged = paged
        own_length = bool(cfg.num_experts)   # see the module docstring
        if not paged:
            self.decode = make_serve_decode_step(cfg)
            if {SSM, REC} & set(cfg.layer_kinds()):
                self.cache_len = max_len
                self.prefill = make_prefill_step(cfg)
            else:
                # the paged path's one prefill shape (train/serve.py)
                self.cache_len = (-(-max_len // DEFAULT_PAGE_SIZE)
                                  * DEFAULT_PAGE_SIZE)
                self.prefill = make_prefill_step(
                    cfg, pad_to=None if own_length else self.cache_len)
            return
        self.page_size = page_size
        self.pages_per_row = -(-max_len // page_size)
        self.cache_len = self.pages_per_row * page_size
        self.num_pages = (num_pages if num_pages is not None
                          else num_slots * self.cache_len // page_size + 1)
        self.max_active = max_active if max_active is not None else num_slots
        self.prefix_cache = prefix_cache
        self.prefill = make_prefill_step(
            cfg, pad_to=None if own_length else self.cache_len)
        self.paged_decode = make_paged_decode_step(cfg)

    @property
    def num_rows(self) -> int:
        """Rows the decode step advances per call (pool width)."""
        return self.max_active if self.paged else self.num_slots

    def make_pool(self, registry=None):
        if not self.paged:
            return CachePool(self.cfg, self.num_slots, self.device,
                             cache_len=self.cache_len)
        return PagedKVCache(self.cfg, self.num_pages, self.page_size,
                            self.cache_len, self.max_active,
                            prefix=self.prefix_cache, registry=registry,
                            device=self.device)


class Replica:
    def __init__(self, replica_id: int, params: Any, fns: ServeFns,
                 sentinel: Optional[DecodeSentinel] = None,
                 hosts: Optional[Sequence[int]] = None,
                 registry=None):
        self.id = replica_id
        self.params = params
        self.fns = fns
        self.pool = fns.make_pool(registry=registry)
        self.sentinel = sentinel
        # one heartbeat identity per host; default one host = replica id
        self.hosts: Tuple[int, ...] = (tuple(int(h) for h in hosts)
                                       if hosts is not None
                                       else (replica_id,))
        self.emitters: List[HeartbeatEmitter] = []
        self.healthy = True
        self.fail_reason: Optional[str] = None
        self.steps = 0                      # decode steps this replica ran
        self.prefills = 0                   # prefills this replica ran

    # ------------------------------------------------------------------
    # heartbeat
    # ------------------------------------------------------------------
    @property
    def emitter(self) -> Optional[HeartbeatEmitter]:
        return self.emitters[0] if self.emitters else None

    def attach_emitter(self, monitor_addr, period: float) -> None:
        for h in self.hosts:
            self.emitters.append(
                HeartbeatEmitter(h, tuple(monitor_addr),
                                 period=period).start())

    def shutdown(self) -> None:
        for em in self.emitters:
            em.stop()
        self.emitters = []

    # ------------------------------------------------------------------
    # model steps
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, prompt: Sequence[int]) -> Tuple[int, Any]:
        """Run B=1 prefill for one request; returns (first greedy token,
        filled cache row) — the caller writes the row into the pool."""
        if len(prompt) > self.fns.max_len:
            raise ValueError(f"prompt length {len(prompt)} exceeds "
                             f"max_len {self.fns.max_len}")
        dev = self.fns.device
        toks = torch.tensor([list(prompt)], dtype=torch.long, device=dev)
        row = init_cache(self.fns.cfg, 1, self.fns.cache_len, dev)
        tok, row = self.fns.prefill(self.params, {"tokens": toks}, row)
        self.prefills += 1
        return int(tok[0]), row

    @torch.no_grad()
    def decode(self, last_tokens) -> Tuple[np.ndarray, Dict[str, Any]]:
        """One decode step over the WHOLE pool: ``last_tokens`` is
        (num_rows,) int — the previous token per row, arbitrary for
        inactive rows (their outputs are ignored).  Paged pools advance
        every row through its page table; slot pools advance every slot's
        row (inactive ones on stale state).  Returns (tokens (num_rows,),
        stats with per-row nonfinite and entropy) on the host."""
        dev = self.fns.device
        pool = self.pool
        batch = {"tokens": torch.tensor(np.asarray(last_tokens),
                                        dtype=torch.long,
                                        device=dev).reshape(-1, 1)}
        if self.fns.paged:
            batch["lengths"] = torch.tensor(pool.lengths, dtype=torch.int32,
                                            device=dev)
            batch["page_tables"] = torch.tensor(pool.page_tables,
                                                dtype=torch.int32,
                                                device=dev)
            toks, pool.pages, stats = self.fns.paged_decode(
                self.params, batch, pool.pages)
        else:
            toks, pool.cache, stats = self.fns.decode(self.params, batch,
                                                      pool.cache)
        self.steps += 1
        return (toks.cpu().numpy().reshape(-1),
                {k: v.cpu().numpy() for k, v in stats.items()})


def restore_standby_params(manager, like) -> Tuple[Any, int]:
    """Warm-standby restore path: pull the newest verifying params
    checkpoint through ``CheckpointManager.restore_latest`` (walks back
    past CRC-corrupt checkpoints exactly like training recovery does).
    ``like``: template tree of the params; each leaf is restored onto its
    template's device.  Returns (params, step)."""
    state, _local, step, _skipped = manager.restore_latest(
        like={"params": like})
    return state["params"], step


def make_standby_source(manager, like):
    """Returns a zero-arg callable the router uses to materialize a warm
    standby's params on activation."""
    def source():
        params, _ = restore_standby_params(manager, like)
        return params
    return source


__all__ = ["Replica", "ServeFns", "restore_standby_params",
           "make_standby_source"]
