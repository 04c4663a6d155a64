"""Deterministic, checkpointable, per-host-sharded synthetic data pipeline
(the reference's ``data/pipeline.py``).

Every batch is a pure function of ``(seed, step, shard)``: the reference's
counter-based threefry key for that triple (``prng.fold_in``) seeds a
``torch.Generator`` that draws the tokens — no stateful iterators.  The
numbers differ from ``jax.random``'s; the contract (pure in its inputs,
and in slice mode independent of the DP width) is the same, and the
local-state records (the shard key) are the reference's exactly.  The *local state* in DeLIA terms is
therefore a tiny cursor ``{"step": int}`` per shard: O(1) save/restore with
exact resume, which directly fixes the local-save limitation the paper hit
with Julia's Distributed module (DESIGN.md S2).

Two shard modes:

- ``"fold"`` (legacy): each host folds its id into the RNG key, so the
  global batch *content* depends on how many hosts there are.  Exact resume
  requires the same width.
- ``"slice"`` (elastic): the GLOBAL batch is a pure function of
  ``(seed, step)`` alone and each shard takes a contiguous row slice.  The
  merged batch is identical for any DP width, so a checkpoint taken at
  width W restores onto width W' with the loss trajectory unchanged — the
  property the elastic failover loop (core/elastic_loop.py) relies on.

``ShardedPipeline`` models local-SCOPE state: one cursor + RNG record per
DP shard, saved as its own checkpoint file (core/checkpoint.py
``local_shards``) and remapped onto the current width on restore.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.models.base import ModelConfig
from repro_torch.prng import fold_in, prng_key

SHARD_MODES = ("fold", "slice")


def _shard_rng(seed: int, shard: int) -> List[int]:
    """Shard ``shard``'s derived RNG key — pure in (seed, shard), so a
    restore can recompute it and verify the saved record."""
    return list(fold_in(prng_key(seed), shard))


def even_spans(n: int, width: int):
    """``width`` near-equal contiguous spans tiling ``[0, n)`` — the one
    partition formula every local-scope provider shares (rows here, shots
    in apps/fwi), so the rounding and its tiling invariant cannot drift
    between copies."""
    assert 1 <= width <= n, (width, n)
    bounds = [round(k * n / width) for k in range(width + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


@dataclasses.dataclass
class SyntheticLMData:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    step: int = 0
    shard_mode: str = "fold"

    def __post_init__(self):
        assert self.shard_mode in SHARD_MODES, self.shard_mode
        self._rng_record = None            # (seed, shard)-pure; lazy cache
        if self.shard_mode == "slice":
            self._set_span()
        else:
            assert self.global_batch % self.num_hosts == 0, \
                (self.global_batch, self.num_hosts)
            self.host_batch = self.global_batch // self.num_hosts

    def _set_span(self) -> None:
        """Near-equal contiguous row span for (host_id, num_hosts); widths
        that don't divide the global batch are fine (elastic shrink to any
        survivor count), the spans just differ by one row."""
        self.row_lo, self.row_hi = even_spans(
            self.global_batch, self.num_hosts)[self.host_id]
        self.host_batch = self.row_hi - self.row_lo
        self._rng_record = None            # (seed, shard)-pure; lazy cache

    # ---- DeLIA local state ----
    def shard_rng(self):
        """This shard's derived RNG key (pure: (seed, shard))."""
        return _shard_rng(self.seed, self.host_id)

    def state_dict(self) -> Dict:
        if self._rng_record is None:       # once per shard lifetime
            self._rng_record = self.shard_rng()
        return {"step": int(self.step), "seed": int(self.seed),
                "host_id": int(self.host_id), "shard": int(self.host_id),
                "width": int(self.num_hosts), "mode": self.shard_mode,
                "rng": self._rng_record}

    def load_state_dict(self, state: Dict) -> None:
        assert int(state["seed"]) == self.seed, "seed mismatch on restore"
        mode = state.get("mode", "fold")
        assert mode == self.shard_mode, (mode, self.shard_mode)
        width = int(state.get("width", self.num_hosts))
        if self.shard_mode == "fold":
            # fold mode bakes the width into the batch content: resuming at
            # a different width would silently change the data stream
            assert width == self.num_hosts, \
                f"fold-mode restore across widths ({width}->{self.num_hosts})"
        if (state.get("rng") is not None
                and int(state.get("shard", self.host_id)) == self.host_id):
            # the recorded key is pure in (seed, shard): a mismatch means
            # the saved dict was corrupted or belongs to another stream
            assert list(state["rng"]) == self.shard_rng(), \
                "shard RNG mismatch"
        self.step = int(state["step"])

    def repartition(self, host_id: int, num_hosts: int) -> None:
        """Reassign this pipeline's shard for a new DP width (slice mode:
        the merged global batch is unchanged, only the row span moves)."""
        assert self.shard_mode == "slice", \
            "repartition requires shard_mode='slice'"
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._set_span()

    # ---- batches ----
    def _generator(self, step: int) -> torch.Generator:
        k = fold_in(prng_key(self.seed), step)
        if self.shard_mode == "fold":
            k = fold_in(k, self.host_id)
        gen = torch.Generator()
        gen.manual_seed((k[0] << 32) | k[1])
        return gen

    def _full_rows(self) -> int:
        """Rows generated per batch: the host rows (fold) or the full
        global batch that slice mode cuts its span from."""
        return self.host_batch if self.shard_mode == "fold" \
            else self.global_batch

    def peek_global_batch(self, step: Optional[int] = None) -> Dict:
        """Slice mode only: the full width-independent global batch (what
        the shard slices its span from).  One generation serves the whole
        DP group — ShardedPipeline uses this instead of paying the
        generation cost once per shard."""
        assert self.shard_mode == "slice"
        return self._generate(self.step if step is None else step)

    def peek_batch(self, step: Optional[int] = None) -> Dict:
        """Batch for an arbitrary step (pure; does not advance the cursor)."""
        step = self.step if step is None else step
        batch = self._generate(step)
        if self.shard_mode == "slice":
            lo, hi = self.row_lo, self.row_hi
            batch = {k: (v[:, lo:hi] if k == "positions" else v[lo:hi])
                     for k, v in batch.items()}
        return batch

    def _generate(self, step: int) -> Dict:
        """CPU tensors, the reference's keys: int32 ``tokens`` and
        ``targets`` (B, S), or for an embedding-input stack
        ``embeddings`` (B, S, D), normal x 0.02 in the compute dtype, and
        ``targets``; under M-RoPE int32 text ``positions`` (3, B, S).  The
        train step moves them to the state's device."""
        cfg = self.cfg
        B, S = self._full_rows(), self.seq_len
        gen = self._generator(step)
        if cfg.embedding_inputs:
            emb = torch.randn(B, S, cfg.d_model, generator=gen)
            batch = {"embeddings": emb.to(cfg.dtype) * 0.02,
                     "targets": torch.randint(0, cfg.vocab_size, (B, S),
                                              generator=gen,
                                              dtype=torch.int32)}
        else:
            toks = torch.randint(0, cfg.vocab_size, (B, S + 1),
                                 generator=gen, dtype=torch.int32)
            batch = {"tokens": toks[:, :-1].contiguous(),
                     "targets": toks[:, 1:].contiguous()}
        if cfg.mrope_sections:
            pos = torch.arange(S, dtype=torch.int32)
            batch["positions"] = pos.expand(3, B, S).contiguous()
        return batch

    def next_batch(self) -> Dict:
        b = self.peek_batch()
        self.step += 1
        return b


class ShardedPipeline:
    """``dp_width`` slice-mode shards driven in lockstep (one process
    simulating the whole DP group, as the elastic tests do).

    ``next_batch`` merges the shard slices back into the width-independent
    global batch; the DeLIA *local scope* is one dict per shard
    (``shard_state_dicts``), each persisted as its own file and remapped
    onto the pipeline's CURRENT width on restore (``load_shard_state_dicts``)
    — the shard count may have changed in between (elastic shrink/grow).
    """

    def __init__(self, cfg: ModelConfig, seq_len: int, global_batch: int,
                 dp_width: int = 1, seed: int = 0):
        self.cfg = cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.remapped_from: Optional[int] = None
        self._build(dp_width, step=0)

    def _build(self, width: int, step: int) -> None:
        assert 1 <= width <= self.global_batch, (width, self.global_batch)
        self.dp_width = width
        self.shards = [
            SyntheticLMData(self.cfg, self.seq_len, self.global_batch,
                            seed=self.seed, host_id=i, num_hosts=width,
                            step=step, shard_mode="slice")
            for i in range(width)
        ]

    @property
    def step(self) -> int:
        return self.shards[0].step

    def repartition(self, dp_width: int) -> None:
        if dp_width != self.dp_width:
            self._build(dp_width, step=self.step)

    def next_batch(self) -> Dict:
        steps = {s.step for s in self.shards}
        assert len(steps) == 1, f"shard cursors diverged: {steps}"  # BSP
        # the merged batch IS the width-independent global batch, so
        # generate it once rather than once per shard; the shards'
        # contribution is their cursors (local scope), advanced in lockstep
        batch = self.shards[0].peek_global_batch()
        for s in self.shards:
            s.step += 1
        return batch

    # ---- DeLIA local scope ----
    def state_dict(self) -> Dict:
        return {"step": int(self.step), "seed": int(self.seed),
                "width": int(self.dp_width), "scope": "sharded"}

    def load_state_dict(self, state: Dict) -> None:
        assert int(state["seed"]) == self.seed, "seed mismatch on restore"
        self._build(self.dp_width, step=int(state["step"]))

    def shard_state_dicts(self) -> List[Dict]:
        return [s.state_dict() for s in self.shards]

    def load_shard_state_dicts(self, dicts: List[Dict]) -> None:
        """Remap saved per-shard cursors onto the current width.  The saved
        width may differ; slice mode guarantees the merged stream is
        identical, so only the (agreed, BSP-synchronous) cursor carries
        over while the row spans are recomputed for ``self.dp_width``."""
        assert dicts, "no shard state to load"
        steps = {int(d["step"]) for d in dicts}
        assert len(steps) == 1, f"saved shard cursors diverged: {steps}"
        for d in dicts:
            assert int(d["seed"]) == self.seed, "seed mismatch on restore"
            assert d.get("mode", "slice") == "slice", d
            if d.get("rng") is not None:
                # per-shard RNG is pure in (seed, shard): recompute and
                # verify the record round-tripped intact
                exp = _shard_rng(self.seed, int(d["shard"]))
                assert list(d["rng"]) == exp, \
                    f"shard {d['shard']} RNG record corrupted"
        saved_width = int(dicts[0].get("width", len(dicts)))
        assert len(dicts) == saved_width, (len(dicts), saved_width)
        self.remapped_from = saved_width
        self._build(self.dp_width, step=steps.pop())


def make_pipeline(cfg: ModelConfig, seq_len: int, global_batch: int,
                  seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                  shard_mode: str = "fold") -> SyntheticLMData:
    return SyntheticLMData(cfg, seq_len, global_batch, seed=seed,
                           host_id=host_id, num_hosts=num_hosts,
                           shard_mode=shard_mode)
