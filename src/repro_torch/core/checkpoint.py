"""Atomic checkpoint manager over trees of tensors: the reference's
``core/checkpoint.py`` full-save path, writing and reading the same
format, so a checkpoint written by either package restores in the other.

Layout (one directory per step):

    <dir>/step_00000420/
        manifest_h<i>.json          global shapes/dtypes/codec/CRCs/spans
        <leaf-name>.s<i>_<k>.npy    host i's shard k of that leaf (.npy)
        local_h<i>.json             per-host local state
        local_s<k>.json             per-shard local state (optional)
        ack_h<i>                    per-host completion marker
    <dir>/step_00000420.tmp.<pid>   staging dir, atomically renamed

Leaf names are the reference's dotted paths (``tree.flatten_named``:
dict keys sorted).  Sharded saves (``save(..., shardings=, like=)``, one
rank a host on a mesh): each host writes its own shard of each leaf with
its ``spans`` into the global shape, and a shard that several ranks
hold (a replicated axis) is written once, by its replica 0, as the
reference writes its ``addressable_shards``.  ``mesh_meta`` records the
grid the state was sharded on (``manifest_meta``).  Commit protocol:
every host writes shards + ack into one staging dir (named after host
0's process, ``owner_pid``); host 0 waits for every ack and renames it
into place (single-process runs commit immediately).  A reader only trusts
directories whose manifest parses and whose CRCs verify — a crash
mid-write never corrupts the latest checkpoint.  Staging directories
abandoned by crashed writers are swept on manager init and at every GC.

Fast path (the Young/Daly C term, end to end):

1. *Snapshot* (the only on-critical-path cost in async mode): with
   ``device_codec=True`` each floating leaf >= 1 KiB elements is quantized
   to int8 + per-block fp32 scales on its device (the CUDA kernel of
   ``kernels/ckpt_codec`` on the card) and only the int8 payload crosses
   the device->host link: ~3.9x fewer bytes than fp32.
2. *Write*: shards are encoded (host codec, if any) and written
   concurrently by a ``ShardIOEngine`` thread pool; each ``.npy`` is
   streamed with its CRC32 computed in the same pass.
3. *Durability*: fsync is batched — files first, then one directory fsync.
4. *Restore*: shard loads run on the same pool and are CRC-verified; with
   ``device_codec=True`` an int8 leaf moves to its target device as int8
   + scales and is decoded there (the dequantize kernel on the card:
   4x fewer bytes to the device, the same bits as the host decode); a
   restore onto shardings does so with each int8 shard that overlaps the
   rank's region, and assembles the region on the device.

Async mode: ``save(..., blocking=False)`` snapshots to host memory and
hands serialization to a writer thread (double-buffered: a new save
drains the previous one; ``wait()`` re-raises writer errors).

Incremental ("delta") mode (``delta=True``):

Each leaf is split into fixed-size blocks of ``delta_block`` elements
whose mod-2^32 position-weighted word hashes are computed on the card by
the block_hash kernel (every leaf of the save in one launch, one copy of
the hash vectors to the host; the same reduction the SDC scrubber uses for
leaf checksums).  A save writes only the blocks whose hash changed since
the last committed checkpoint, gathered on the card (and, with
``device_codec``, quantized there): clean blocks become manifest
references into the parent step's files, forming a bounded-depth chain
(``full_every`` forces a periodic full save; a restore resets the base,
so the save after a rollback is always full).  ``delta_block`` must be a
multiple of the int8 codec's 256-element block so a standalone encode of
the dirty blocks is bit-identical to the matching slice of a full-save
encode: delta restores are bit-exact against a full-save oracle for
every codec config.  Each shard records the lineage id (``sid``) of the
save that wrote it and a delta shard the ids of its parents, so a step
number regenerated after a walk-back never resolves a stale chain.
``_gc`` is chain-aware: a parent step survives ``keep`` while any
retained child references it; a corrupt parent invalidates every child
that references it.  The manifest is the reference's, so a chain written
by either package restores in the other.  A delta leaf is assembled from
its chain on the host; with ``device_codec`` an int8-coded chain is
assembled still encoded (int8 blocks and fp32 scales in the order a full
save writes them) and decoded once on the target device, as a full
restore is.

Elastic restore: ``restore(shardings=)`` reads, for each leaf, only the
region the calling rank's sharding needs (each stored shard that
overlaps it, through its delta chain and codec) and assembles it: a
checkpoint written on one mesh restores onto any other, the reference's
included (its manifests carry the same spans).
"""
from __future__ import annotations

import functools
import json
import os
import re
import shutil
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.codec import (CODECS, Codec, DeviceCodec,
                                    validate_delta_block)
from repro_torch.core.io_engine import (ShardIOEngine, crc32_array,
                                        fsync_path, pid_alive, read_json,
                                        write_json, write_npy)
from repro_torch.kernels.block_hash.ops import host_block_hashes
from repro_torch.kernels.block_hash.ref import block_hashes_np
from repro_torch.tree import flatten_named, unflatten

_STEP_RE = re.compile(r"^step_(\d{8})$")
_STAGING_RE = re.compile(r"^step_(\d{8})\.tmp\.(\d+)$")
_LOCAL_SHARD_RE = re.compile(r"^local_s(\d{5})\.json$")

# leaves below this many elements are always saved in full (the codecs'
# floor: hashing and packing would cost more than the bytes saved)
_DELTA_MIN_ELEMS = 1024

# seconds host 0 of a sharded save waits for the other hosts' acks
_COMMIT_TIMEOUT = 600.0

# tensor dtype <-> the numpy dtype name the manifest records
_TORCH_DTYPES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.uint16: "uint16",
    torch.uint32: "uint32", torch.uint64: "uint64", torch.bool: "bool"}
_FROM_NAME = {v: k for k, v in _TORCH_DTYPES.items()}


def _dtype_name(value) -> str:
    if isinstance(value, torch.Tensor):
        return _TORCH_DTYPES[value.dtype]
    return str(np.asarray(value).dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy.  bfloat16 (no numpy dtype) becomes
    raw 2-byte void, as the reference writes ml_dtypes' bfloat16."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    # ascontiguousarray makes a 0-d array 1-d: keep the leaf's shape
    c = np.ascontiguousarray(a).reshape(a.shape)
    if dtype_name == "bfloat16":
        return torch.from_numpy(c.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(c).to(device)


def _numel(value) -> int:
    return (value.numel() if isinstance(value, torch.Tensor)
            else int(np.asarray(value).size))


def _gather_blocks(data, idx: np.ndarray, block: int):
    """Blocks ``idx`` (ascending) of the flattened leaf, concatenated flat,
    the ragged last block zero-padded to ``block`` elements.  A tensor is
    gathered on its own device, so only the dirty bytes cross to the
    host."""
    if isinstance(data, torch.Tensor):
        flat = data.detach().reshape(-1)
        n = flat.numel()
        nfull = n // block
        full, tail = idx[idx < nfull], idx[idx >= nfull]
        parts = []
        if full.size:
            sel = torch.from_numpy(full.astype(np.int64)).to(flat.device)
            parts.append(flat[:nfull * block].view(nfull, block)
                         .index_select(0, sel).reshape(-1))
        if tail.size:
            last = flat.new_zeros(block)
            last[:n - nfull * block] = flat[nfull * block:]
            parts.append(last)
        return parts[0] if len(parts) == 1 else torch.cat(parts)
    flat = np.ascontiguousarray(data).reshape(-1)
    pad = (-flat.size) % block
    if pad:
        flat = np.pad(flat, (0, pad))
    return np.ascontiguousarray(flat.reshape(-1, block)[idx].reshape(-1))


class _Encoded:
    """A verified int8 leaf kept encoded so that it is decoded on its
    target device: ``q`` the bytes of its int8 blocks, ``scales`` the bytes
    of their fp32 scales, ``meta`` the codec's manifest entry."""

    def __init__(self, q: np.ndarray, scales: np.ndarray,
                 meta: Dict[str, Any]):
        self.q = q
        self.scales = scales
        self.meta = meta


class _Region:
    """A leaf's region to assemble on its target device: ``shape`` its
    extent, ``pieces`` one (payload, shard extent, source slices, target
    slices) per overlapping stored shard, each payload kept ``_Encoded``
    where it was int8-coded."""

    def __init__(self, shape: Tuple[int, ...], pieces: List[Tuple]):
        self.shape = shape
        self.pieces = pieces


class _NotEncoded(Exception):
    """A link of a delta chain is not int8-coded: the chain cannot be
    assembled encoded."""


class SaveStats:
    def __init__(self, step, bytes_written, snapshot_s, write_s, blocking,
                 kind="full", dirty_blocks=0, total_blocks=0,
                 hash_s=0.0):
        self.step = step
        self.bytes_written = bytes_written
        self.snapshot_seconds = snapshot_s
        self.write_seconds = write_s
        self.blocking = blocking
        self.kind = kind                      # "full" | "delta"
        self.dirty_blocks = dirty_blocks      # blocks written (delta mode)
        self.total_blocks = total_blocks      # blocks tracked (delta mode)
        self.hash_seconds = hash_s            # block hashing, in snapshot

    def __repr__(self):
        extra = ""
        if self.total_blocks:
            extra = (f", kind={self.kind}, blocks={self.dirty_blocks}/"
                     f"{self.total_blocks}")
        return (f"SaveStats(step={self.step}, MB={self.bytes_written/1e6:.1f},"
                f" snapshot={self.snapshot_seconds:.3f}s,"
                f" write={self.write_seconds:.3f}s, blocking={self.blocking}"
                f"{extra})")


class CheckpointManager:
    # staging dirs currently owned by a live writer of THIS process — the
    # stale-staging sweep must never remove these.  Refcounted: several
    # managers of one process may register the same staging path.
    _ACTIVE_STAGING: Dict[str, int] = {}
    _STAGING_LOCK = threading.Lock()

    def __init__(self, directory: str, *, host_id: int = 0, num_hosts: int = 1,
                 codec: Optional[str] = None, device_codec: bool = False,
                 io_threads: int = 0, fsync: str = "batch",
                 verify_crc: bool = True, keep: int = 3,
                 delta: bool = False, delta_block: int = 65536,
                 full_every: int = 8, owner_pid: Optional[int] = None):
        self.directory = directory
        self.host_id = host_id
        self.num_hosts = num_hosts
        # the staging dir every host of a save writes into is named after
        # host 0's process (its pid keeps the dir from stale sweeps)
        self.owner_pid = os.getpid() if owner_pid is None else owner_pid
        if device_codec:
            if codec not in (None, "int8"):
                raise ValueError(
                    f"device_codec implies the int8 layout, got codec={codec!r}")
            codec = "int8"
        self.codec: Optional[Codec] = CODECS[codec] if codec else None
        self.codec_name = codec
        self._dcodec: Optional[DeviceCodec] = (DeviceCodec()
                                               if device_codec else None)
        self._engine = ShardIOEngine(threads=io_threads, fsync_mode=fsync)
        self.verify_crc = verify_crc
        self.keep = keep
        self.delta = bool(delta)
        self.delta_block = (validate_delta_block(delta_block) if delta
                            else int(delta_block))
        if delta and full_every < 1:
            raise ValueError(f"full_every must be >= 1, got {full_every}")
        self.full_every = int(full_every)
        # per-shard base of the last committed save: fname -> {step, hashes,
        # block_steps, step_sids, spans, dtype, size}.  In memory only: a
        # restarted manager saves one full checkpoint first.  ``step_sids``
        # maps each referenced step to the lineage id its shards were
        # saved under, which restore verifies.
        self._delta_base: Dict[str, Dict[str, Any]] = {}
        self._chain_len = 0           # delta saves since the last full
        self._my_staging: Set[str] = set()
        os.makedirs(directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._writer_err: Optional[BaseException] = None
        self._sweep_stale_staging()

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def set_hosts(self, host_id: int, num_hosts: int,
                  owner_pid: Optional[int] = None) -> None:
        """The writer's place among the hosts of the next saves (a mesh
        change renumbers them); ``owner_pid`` is host 0's process."""
        self.wait()
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.owner_pid = os.getpid() if owner_pid is None else owner_pid

    def _staging(self, step: int) -> str:
        return os.path.join(self.directory,
                            f"step_{step:08d}.tmp.{self.owner_pid}")

    def _final(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def _register_staging(self, path: str) -> None:
        active = CheckpointManager._ACTIVE_STAGING
        with CheckpointManager._STAGING_LOCK:
            active[path] = active.get(path, 0) + 1
        self._my_staging.add(path)

    def _unregister_staging(self, path: str) -> None:
        if path not in self._my_staging:
            return
        self._my_staging.discard(path)
        active = CheckpointManager._ACTIVE_STAGING
        with CheckpointManager._STAGING_LOCK:
            count = active.get(path, 0)
            if count <= 1:
                active.pop(path, None)
            else:
                active[path] = count - 1

    def _clear_staging(self, path: str) -> None:
        self._my_staging.discard(path)
        with CheckpointManager._STAGING_LOCK:
            CheckpointManager._ACTIVE_STAGING.pop(path, None)

    def _sweep_stale_staging(self) -> None:
        """Remove ``step_<n>.tmp.<pid>`` staging dirs abandoned by crashed
        writers: stale unless a writer of this process has it registered,
        or its pid suffix belongs to another live process."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return
        for dname in names:
            m = _STAGING_RE.match(dname)
            if not m:
                continue
            path = os.path.join(self.directory, dname)
            with CheckpointManager._STAGING_LOCK:
                if CheckpointManager._ACTIVE_STAGING.get(path, 0) > 0:
                    continue
            pid = int(m.group(2))
            if pid_alive(pid) and (pid != os.getpid()
                                   or self.num_hosts > 1):
                # another live process's, or this host 0's while the
                # other hosts of a sharded save may still be writing
                continue
            shutil.rmtree(path, ignore_errors=True)

    def _dcodec_ok(self, data) -> bool:
        """Would a full save device-encode this leaf?  A delta save encodes
        its gathered dirty blocks iff the full save would have (decided on
        the original leaf), or the decoded values would diverge from the
        full-save oracle."""
        return (self._dcodec is not None and isinstance(data, torch.Tensor)
                and data.is_floating_point() and data.numel() >= 1024)

    def _host_codec_ok(self, data) -> bool:
        """The same for the host codec in the writer pool (numpy leaves,
        and tensors without the device codec)."""
        if self.codec is None:
            return False
        return (_dtype_name(data) in ("float32", "float64")
                and _numel(data) >= 1024)

    def _append_payload(self, item, smeta, payload, pending,
                        dcodec_ok: bool, host_codec_ok: bool) -> None:
        """Route one payload (a whole leaf or its gathered dirty blocks)
        into the write plan: encode on the device, or hand to the host
        (tensors are copied after every kernel of the save is enqueued)."""
        if dcodec_ok and isinstance(payload, torch.Tensor):
            q, s = self._dcodec.encode(payload)
            smeta["codec"] = {"name": self.codec_name,
                              **DeviceCodec.block_meta(tuple(payload.shape))}
            item["kind"] = "parts"
            pending.append((item, "parts", (q, s)))
            return
        item["kind"] = "host"
        item["codec_ok"] = host_codec_ok
        if isinstance(payload, torch.Tensor):
            pending.append((item, "data", payload))
        else:
            item["data"] = np.asarray(payload)

    def _snapshot(self, named, step: int, kind: str, sid: str,
                  layout=None):
        """Device -> host: the only cost on the BSP critical path in async
        mode.  With device_codec, eligible leaves are quantized on their
        device first (every kernel is enqueued before the first copy), so
        only int8 + scales cross the link.  In delta mode every leaf's
        block hashes come first (one kernel launch and one copy of the
        hash vectors), and only dirty blocks are gathered and copied.

        Returns (shard_plan, manifest_arrays, pending_base, dirty, total,
        hash_s); each plan item owns its manifest shard-meta dict (the
        writer adds codec/crc info) and ``pending_base`` is the delta base
        to commit once the write lands on disk."""
        manifest_arrays: Dict[str, Any] = {}
        rows: List[Dict[str, Any]] = []
        for i, (name, value) in enumerate(named):
            shape = list(value.shape) if hasattr(value, "shape") else []
            fname = f"{name}.s{self.host_id}_0.npy"
            spans = [[0, d] for d in shape]
            dtype = _dtype_name(value)
            lay = layout[i] if layout is not None else None
            if lay is not None:
                sh, gshape = lay
                shape = [int(d) for d in gshape]
                if shape:
                    spans = sh.spans(shape)
                if sh.replica_id() != 0:
                    # another rank holds this shard: written once, there
                    manifest_arrays[name] = {"shape": shape, "dtype": dtype,
                                             "shards": []}
                    continue
            smeta: Dict[str, Any] = {"file": fname, "spans": spans}
            if self.delta:
                smeta["sid"] = sid       # lineage id delta children pin
            manifest_arrays[name] = {"shape": shape, "dtype": dtype,
                                     "shards": [smeta]}
            row = {"fname": fname, "meta": smeta, "spans": spans,
                   "data": value, "dtype": dtype}
            if self.delta and _numel(value) >= _DELTA_MIN_ELEMS:
                if isinstance(value, torch.Tensor):
                    row["hash_me"] = True
                else:
                    row["hashes"] = block_hashes_np(np.asarray(value),
                                                    self.delta_block)
            rows.append(row)
        t0 = time.perf_counter()
        pend = [r for r in rows if r.pop("hash_me", False)]
        if pend:
            for r, h in zip(pend, host_block_hashes(
                    [r["data"] for r in pend], self.delta_block)):
                r["hashes"] = h
        hash_s = time.perf_counter() - t0

        plan: List[Dict[str, Any]] = []
        pending_base: Dict[str, Dict[str, Any]] = {}
        dirty_total = blocks_total = 0
        pending: List[Tuple[Dict[str, Any], str, Any]] = []
        for row in rows:
            fname, smeta, data = row["fname"], row["meta"], row["data"]
            item: Dict[str, Any] = {"fname": fname, "meta": smeta}
            base = self._delta_base.get(fname)
            h = row.get("hashes")
            size = _numel(data)
            if h is not None:
                pending_base[fname] = {
                    "step": step, "hashes": h, "spans": row["spans"],
                    "dtype": row["dtype"], "size": size,
                    "block_steps": np.full(h.size, step, np.int64),
                    "step_sids": {step: sid}}
                blocks_total += h.size
            use_delta = (kind == "delta" and h is not None
                         and base is not None
                         and base["spans"] == row["spans"]
                         and base["dtype"] == row["dtype"]
                         and base["size"] == size)
            if use_delta:
                dirty = np.nonzero(h != base["hashes"])[0]
                if dirty.size == h.size:
                    use_delta = False       # fully dirty: plain full shard
            if not use_delta:
                if h is not None:
                    dirty_total += h.size
                self._append_payload(item, smeta, data, pending,
                                     dcodec_ok=self._dcodec_ok(data),
                                     host_codec_ok=self._host_codec_ok(data))
                plan.append(item)
                continue
            dirty_total += int(dirty.size)
            block_steps = base["block_steps"].copy()
            block_steps[dirty] = step
            clean = np.nonzero(h == base["hashes"])[0]
            parents: Dict[int, List[int]] = {}
            for b in clean:
                parents.setdefault(int(base["block_steps"][b]),
                                   []).append(int(b))
            pending_base[fname]["block_steps"] = block_steps
            pending_base[fname]["step_sids"] = {
                step: sid, **{s: base["step_sids"][s] for s in parents}}
            smeta["delta"] = {
                "block": self.delta_block, "nblocks": int(h.size),
                "size": size,
                "local": [int(b) for b in dirty],
                "parents": {str(s): bs for s, bs in sorted(parents.items())},
                "parent_sids": {str(s): base["step_sids"][s]
                                for s in parents},
            }
            if dirty.size == 0:
                smeta["file"] = None     # nothing local: pure reference
                continue
            gathered = _gather_blocks(data, dirty, self.delta_block)
            self._append_payload(item, smeta, gathered, pending,
                                 dcodec_ok=self._dcodec_ok(data),
                                 host_codec_ok=self._host_codec_ok(data))
            plan.append(item)
        for item, key, value in pending:
            if key == "parts":
                item["parts"] = [_to_numpy(t) for t in value]
            else:
                item["data"] = _to_numpy(value)
        return (plan, manifest_arrays, pending_base, dirty_total,
                blocks_total, hash_s)

    def _write_shard(self, staging: str, item: Dict[str, Any]) -> Tuple[str, int]:
        """One writer-pool job: (host-)encode + stream one shard to disk."""
        path = os.path.join(staging, item["fname"])
        meta = item["meta"]
        per_file = self._engine.per_file_fsync
        if item["kind"] == "parts":     # device-encoded: q blocks + scales
            nbytes, crc = write_npy(path, item["parts"], fsync=per_file)
        else:
            payload = item["data"]
            if item.get("codec_ok"):
                payload, codec_meta = self.codec.encode(payload)
                meta["codec"] = {"name": self.codec_name, **codec_meta}
            nbytes, crc = write_npy(path, payload, fsync=per_file)
        meta["crc32"] = crc
        return path, nbytes

    def save(self, step: int, state, local_state: Optional[Dict] = None, *,
             local_shards: Optional[List[Dict]] = None,
             mesh_meta: Optional[Dict] = None, shardings=None, like=None,
             blocking: bool = True) -> SaveStats:
        """``local_state``: this host's local-scope dict (one file per host).
        ``local_shards``: one dict per DP shard, each written as its own
        ``local_s<k>.json`` (by host 0: every host holds the same).
        ``mesh_meta``: the mesh the state was sharded on, e.g. ``{"dp": 2,
        "tp": 2, "ep": 2, "moe_ep": 2, "dead_experts": []}``, recorded in
        the manifest (``manifest_meta``).  ``shardings``: a tree of
        ``sharding.api.NamedSharding`` (or None) matching ``state``, whose
        leaves are then this host's shards; ``like``: the tree of global
        shapes (tensors, meta tensors included)."""
        self.wait()  # double-buffer: drain previous async write
        t0 = time.perf_counter()
        kind = "full"
        if (self.delta and self._delta_base
                and self._chain_len + 1 < self.full_every):
            kind = "delta"
        # a fresh lineage id a save: a walk-back + resume can regenerate a
        # step NUMBER with other content; delta children pin the id so a
        # restore refuses to mix generations
        sid = uuid.uuid4().hex[:16]
        named = flatten_named(state)
        layout = None
        if shardings is not None:
            from repro_torch.tree import leaves
            if like is None:
                raise ValueError("a sharded save needs like= (the global "
                                 "shapes)")
            layout = [None if sh is None else (sh, tuple(g.shape))
                      for sh, g in zip(leaves(shardings), leaves(like))]
        (shard_plan, manifest_arrays, pending_base, dirty, total,
         hash_s) = self._snapshot(named, step, kind, sid, layout)
        snapshot_s = time.perf_counter() - t0

        def write():
            t1 = time.perf_counter()
            staging = self._staging(step)
            self._register_staging(staging)
            try:
                os.makedirs(staging, exist_ok=True)
                total_b, paths = self._engine.run_jobs(
                    [functools.partial(self._write_shard, staging, item)
                     for item in shard_plan])
                manifest = {
                    "step": step,
                    "num_hosts": self.num_hosts,
                    "codec": self.codec_name,
                    "kind": kind,
                    "arrays": manifest_arrays,
                }
                if mesh_meta is not None:
                    manifest["mesh"] = dict(mesh_meta)
                if local_shards is not None:
                    manifest["local_shards"] = [int(sd.get("shard", k))
                                                for k, sd in
                                                enumerate(local_shards)]
                mpath = os.path.join(staging, f"manifest_h{self.host_id}.json")
                paths.append(write_json(mpath, manifest))
                if local_state is not None:
                    lpath = os.path.join(staging,
                                         f"local_h{self.host_id}.json")
                    paths.append(write_json(lpath, local_state))
                for k, sd in enumerate((local_shards or ())
                                       if self.host_id == 0 else ()):
                    idx = int(sd.get("shard", k))
                    spath = os.path.join(staging, f"local_s{idx:05d}.json")
                    paths.append(write_json(spath, sd))
                apath = os.path.join(staging, f"ack_h{self.host_id}")
                if self.num_hosts > 1:
                    # this host's files are durable before its ack shows:
                    # host 0 may rename the staging dir on the last ack
                    self._engine.finalize(staging, paths)
                    open(apath, "w").close()
                else:
                    open(apath, "w").close()
                    paths.append(apath)
                    self._engine.finalize(staging, paths)
                # host 0 commits once every host acked (single-process:
                # immediately)
                if self.host_id == 0 and self.num_hosts > 1:
                    self._wait_acks(staging)
                    if self._engine.fsync_mode != "none":
                        fsync_path(staging)     # the acks' entries
                acks = [os.path.exists(os.path.join(staging, f"ack_h{h}"))
                        for h in range(self.num_hosts)]
                if all(acks) and self.host_id == 0:
                    final = self._final(step)
                    if os.path.exists(final):
                        shutil.rmtree(final)
                    os.rename(staging, final)
                    self._clear_staging(staging)
                    if self._engine.fsync_mode != "none":
                        fsync_path(self.directory)  # make the rename durable
                    self._gc()
            except BaseException:
                self._unregister_staging(staging)
                raise
            # the write landed: commit the delta base (a failed write never
            # becomes a parent)
            if self.delta:
                self._delta_base.update(pending_base)
                self._chain_len = 0 if kind == "full" else self._chain_len + 1
            return total_b, time.perf_counter() - t1

        extra = dict(kind=kind, dirty_blocks=dirty, total_blocks=total,
                     hash_s=hash_s)
        if blocking:
            total_b, write_s = write()
            return SaveStats(step, total_b, snapshot_s, write_s, True,
                             **extra)

        stats = SaveStats(step, 0, snapshot_s, 0.0, False, **extra)

        def run():
            try:
                total_b, write_s = write()
                stats.bytes_written = total_b
                stats.write_seconds = write_s
            except BaseException as e:  # surfaced on next wait()
                self._writer_err = e

        self._writer = threading.Thread(target=run, daemon=True)
        self._writer.start()
        return stats

    def _wait_acks(self, staging: str) -> None:
        deadline = time.monotonic() + _COMMIT_TIMEOUT
        want = [os.path.join(staging, f"ack_h{h}")
                for h in range(self.num_hosts)]
        while not all(os.path.exists(p) for p in want):
            if time.monotonic() > deadline:
                missing = [h for h, p in enumerate(want)
                           if not os.path.exists(p)]
                raise IOError(f"{staging}: hosts {missing} did not ack "
                              f"within {_COMMIT_TIMEOUT} s")
            time.sleep(0.005)

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._writer_err is not None:
            err, self._writer_err = self._writer_err, None
            raise err

    def close(self) -> None:
        """Drain the async writer, drop this manager's staging
        registrations and shut the I/O pool down."""
        self.wait()
        for path in list(self._my_staging):
            self._unregister_staging(path)
        self._engine.close()

    def _parent_steps(self, step: int) -> Set[int]:
        """Steps referenced by ``step``'s delta shards (direct parents).
        Raises on an unreadable manifest: callers deciding what to delete
        must treat that conservatively, not as 'no parents'."""
        out: Set[int] = set()
        for entry in self._load_manifests(step).values():
            for sh in entry["shards"]:
                d = sh.get("delta")
                if d:
                    out.update(int(s) for s in d["parents"])
        return out

    def _gc(self) -> None:
        """Prune beyond ``keep``, chain-aware: a step survives while any
        retained delta checkpoint (transitively) references it.  If a
        retained manifest cannot be read, delete nothing this round:
        keeping too much is the safe failure, never too little."""
        steps = self.all_steps()
        if self.keep:
            keep_set: Optional[Set[int]] = set(steps[-self.keep:])
            frontier = list(keep_set)
            try:
                while frontier:
                    for p in self._parent_steps(frontier.pop()):
                        if p not in keep_set:
                            keep_set.add(p)
                            frontier.append(p)
            except (OSError, ValueError, json.JSONDecodeError):
                keep_set = None
            if keep_set is not None:
                for s in steps:
                    if s not in keep_set:
                        shutil.rmtree(self._final(s), ignore_errors=True)
        self._sweep_stale_staging()

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.directory):
            m = _STEP_RE.match(d)
            if m and os.path.exists(os.path.join(self.directory, d,
                                                 "manifest_h0.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest_meta(self, step: Optional[int]) -> Optional[Dict[str, Any]]:
        """The ``mesh_meta`` dict recorded at ``save`` time (None when the
        step has none or does not exist): the (dp, tp, ep) grid and the
        dead experts the checkpoint was written under."""
        if step is None:
            return None
        p = os.path.join(self._final(step), "manifest_h0.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f).get("mesh")

    def _load_manifests(self, step: int) -> Dict[str, Any]:
        """Every host's manifest of ``step`` merged (the hosts that wrote
        it, however many this manager's run has now)."""
        final = self._final(step)
        merged: Dict[str, Any] = {}
        hosts = sorted(int(m.group(1)) for m in
                       (re.match(r"^manifest_h(\d+)\.json$", fn)
                        for fn in os.listdir(final)) if m)
        for h in hosts:
            p = os.path.join(final, f"manifest_h{h}.json")
            with open(p) as f:
                man = json.load(f)
            for name, entry in man["arrays"].items():
                if name not in merged:
                    merged[name] = {"shape": entry["shape"],
                                    "dtype": entry["dtype"], "shards": []}
                merged[name]["shards"].extend(entry["shards"])
        return merged

    def _check_tiling(self, name: str, shape: Tuple[int, ...],
                      shards: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Validate that shard spans EXACTLY tile the leaf and return the
        deduplicated shard list.  Gaps (a lost host manifest) or overlaps
        raise IOError so ``restore_latest`` walks back."""
        total = 1
        for d in shape:
            total *= d
        uniq: List[Dict[str, Any]] = []
        seen = set()
        for sh in shards:
            key = tuple(tuple(s) for s in sh["spans"])
            if key in seen:
                continue
            seen.add(key)
            uniq.append(sh)
        vol = 0
        norm = []
        for sh in uniq:
            spans = sh["spans"]
            if len(spans) != len(shape):
                raise IOError(f"leaf {name!r}: shard span rank "
                              f"{len(spans)} != leaf rank {len(shape)}")
            v = 1
            for (a, b), dim in zip(spans, shape):
                if not (0 <= a < b <= dim):
                    raise IOError(f"leaf {name!r}: span [{a},{b}) outside "
                                  f"dim {dim}")
                v *= b - a
            vol += v
            norm.append(spans)
        for i in range(len(norm)):
            for j in range(i + 1, len(norm)):
                if norm[i] and all(max(a1, a2) < min(b1, b2)
                                   for (a1, b1), (a2, b2)
                                   in zip(norm[i], norm[j])):
                    raise IOError(f"leaf {name!r}: overlapping shard spans "
                                  f"{norm[i]} / {norm[j]}")
        if vol != total:
            raise IOError(
                f"leaf {name!r}: shard spans cover {vol} of {total} "
                "elements — missing host manifest or corrupt checkpoint")
        return uniq

    def _decode_payload(self, final: str, sh: Dict[str, Any],
                        want: str, keep_encoded: bool = False):
        """np.load + CRC verify + codec decode of one shard file (with
        ``keep_encoded``, an int8 payload comes back as ``_Encoded``)."""
        path = os.path.join(final, sh["file"])
        try:
            payload = np.load(path)
        except Exception as e:
            # a corrupted .npy HEADER surfaces as whatever numpy's parser
            # trips over; normalize to IOError so restore_latest walks back
            raise IOError(f"unreadable shard {path}: "
                          f"{type(e).__name__}: {e}") from e
        if self.verify_crc and "crc32" in sh:
            if crc32_array(payload) != sh["crc32"]:
                raise IOError(f"CRC mismatch in {path}")
        if "codec" in sh:
            if keep_encoded:
                nb = int(sh["codec"]["blocks"])
                return _Encoded(payload[:nb * 256], payload[nb * 256:],
                                sh["codec"])
            payload = CODECS[sh["codec"]["name"]].decode(payload, sh["codec"])
        if want == "bfloat16":
            return payload             # raw 2-byte void, viewed on load
        return payload.astype(np.dtype(want), copy=False)

    def _load_plain(self, final: str, sh: Dict[str, Any],
                    want: str) -> np.ndarray:
        """One shard file decoded to the leaf's dtype (bfloat16 as raw
        2-byte void; an int8 payload decoded and rounded to it)."""
        payload = self._decode_payload(final, sh, want)
        if want != "bfloat16":
            return payload
        if payload.dtype.kind == "f":      # decoded int8 payload
            payload = torch.from_numpy(np.ascontiguousarray(
                payload, np.float32)).to(torch.bfloat16).view(
                    torch.int16).numpy()
        return payload.view(np.dtype("V2"))

    def _find_shard(self, step: int, name: str, spans,
                    man_cache: Dict[int, Dict],
                    want_sid: Optional[str] = None) -> Dict[str, Any]:
        """The shard entry for (name, spans) in ``step``'s manifests: the
        delta chain's parent lookup.  Raises IOError when the parent step
        or its shard is gone (the child is invalidated), or when
        ``want_sid`` does not match the shard's lineage id: the parent step
        number was regenerated after a walk-back + resume and holds
        another trajectory, which every per-file CRC would pass."""
        if step not in man_cache:
            if not os.path.isdir(self._final(step)):
                raise IOError(f"delta parent step {step} is missing")
            man_cache[step] = self._load_manifests(step)
        entry = man_cache[step].get(name)
        if entry is None:
            raise IOError(f"delta parent step {step} has no leaf {name!r}")
        for sh in entry["shards"]:
            if sh["spans"] == spans:
                if want_sid is not None and sh.get("sid") != want_sid:
                    raise IOError(
                        f"delta parent step {step} was regenerated "
                        f"(lineage {sh.get('sid')} != referenced "
                        f"{want_sid}): stale chain invalidated")
                return sh
        raise IOError(f"delta parent step {step} has no shard of {name!r} "
                      f"with spans {spans}")

    def _block_parts(self, final: str, sh: Dict[str, Any], want: str,
                     encoded: bool) -> List[np.ndarray]:
        """One shard file as the flat arrays ``_fill_blocks`` copies blocks
        of: its values; or, ``encoded``, the bytes of its int8 blocks and
        of their fp32 scales (raises _NotEncoded on a shard without the
        int8 codec)."""
        if not encoded:
            return [self._load_plain(final, sh, want).reshape(-1)]
        if sh.get("codec", {}).get("name") != "int8":
            raise _NotEncoded(sh["file"])
        raw = self._decode_payload(final, sh, want, keep_encoded=True)
        return [raw.q, raw.scales]

    def _fill_blocks(self, step: int, name: str, spans, block: int,
                     needed: Set[int], outs: List[np.ndarray],
                     units: List[int], want: str,
                     man_cache: Dict[int, Dict], depth: int = 0,
                     want_sid: Optional[str] = None) -> None:
        """Copy the requested delta blocks of shard (name, spans) at
        ``step`` into ``outs`` (flat arrays holding ``unit`` elements a
        delta block: the values, or the int8 blocks' and scales' bytes),
        resolving parent references recursively.  Any missing or corrupt
        link, or a parent whose lineage id shows it was regenerated, raises
        IOError: the whole chain is invalidated."""
        if depth > 64:
            raise IOError(f"delta chain deeper than 64 at step {step} "
                          f"({name!r}): corrupt parent links")
        final = self._final(step)
        sh = self._find_shard(step, name, spans, man_cache, want_sid)
        d = sh.get("delta")
        encoded = len(outs) == 2        # [int8 block bytes, scale bytes]
        if d is None:               # a full shard terminates the chain
            srcs = self._block_parts(final, sh, want, encoded)
            for b in needed:
                for out, src, u in zip(outs, srcs, units):
                    seg = src[b * u:(b + 1) * u]
                    if seg.size == 0:
                        raise IOError(f"delta block {b} of {name!r} out of "
                                      f"range in full shard at step {step}")
                    out[b * u:b * u + seg.size] = seg
            return
        if d["block"] != block:
            raise IOError(f"delta block size changed mid-chain for "
                          f"{name!r} at step {step}")
        pos = {int(b): j for j, b in enumerate(d["local"])}
        here = [b for b in needed if b in pos]
        if here:
            if sh.get("file") is None:
                raise IOError(f"delta shard of {name!r} at step {step} "
                              "lists local blocks but has no file")
            srcs = self._block_parts(final, sh, want, encoded)
            for src, u in zip(srcs, units):
                if src.size < len(pos) * u:
                    raise IOError(f"delta shard of {name!r} at step {step} "
                                  f"truncated: {src.size} < {len(pos) * u}")
            for b in here:
                j = pos[b]
                for out, src, u in zip(outs, srcs, units):
                    out[b * u:(b + 1) * u] = src[j * u:(j + 1) * u]
        rest = needed.difference(here)
        if not rest:
            return
        pmap: Dict[int, int] = {}
        for ps, bs in d["parents"].items():
            for b in bs:
                pmap[int(b)] = int(ps)
        sids = d.get("parent_sids", {})
        byp: Dict[int, Set[int]] = {}
        for b in rest:
            if b not in pmap:
                raise IOError(f"delta block {b} of {name!r} unresolved at "
                              f"step {step}: corrupt manifest")
            byp.setdefault(pmap[b], set()).add(b)
        for s, bs in sorted(byp.items()):
            self._fill_blocks(s, name, spans, block, bs, outs, units, want,
                              man_cache, depth + 1,
                              want_sid=sids.get(str(s)))

    def _assemble_delta(self, step: int, name: str, entry: Dict[str, Any],
                        sh: Dict[str, Any], man_cache: Dict[int, Dict],
                        encoded: bool = False):
        """A delta shard's values through its chain; or, ``encoded``, its
        int8 blocks and scales in a full save's order (every delta block
        is a whole number of 256-element codec blocks), as ``_Encoded``."""
        d = sh["delta"]
        block, nb, size = d["block"], d["nblocks"], d["size"]
        want = entry["dtype"]
        if encoded:
            per = block // 256
            outs = [np.zeros(nb * block, np.uint8),
                    np.zeros(nb * per * 4, np.uint8)]
            units = [block, per * 4]
        else:
            outs = [np.zeros(nb * block, dtype=(np.dtype("V2")
                                                if want == "bfloat16"
                                                else np.dtype(want)))]
            units = [block]
        self._fill_blocks(step, name, sh["spans"], block, set(range(nb)),
                          outs, units, want, man_cache)
        if not encoded:
            return outs[0][:size]
        ncb = -(-size // 256)       # the full save's codec blocks
        return _Encoded(outs[0][:ncb * 256], outs[1][:ncb * 4],
                        {"shape": [b - a for a, b in sh["spans"]],
                         "pad": ncb * 256 - size, "blocks": ncb})

    def _load_shard(self, step: int, name: str, entry: Dict[str, Any],
                    sh: Dict[str, Any], man_cache: Dict[int, Dict],
                    keep_encoded: bool = False):
        """One stored shard's values (a delta shard through its chain;
        bfloat16 as raw 2-byte void), or, ``keep_encoded``, its int8
        blocks as ``_Encoded`` where the shard (its whole chain) is
        int8-coded."""
        if "delta" in sh:
            if keep_encoded:
                try:
                    return self._assemble_delta(step, name, entry, sh,
                                                man_cache, encoded=True)
                except _NotEncoded:
                    pass            # a raw link: assemble the values
            return self._assemble_delta(step, name, entry, sh, man_cache)
        if keep_encoded and "codec" in sh:
            return self._decode_payload(self._final(step), sh,
                                        entry["dtype"], keep_encoded=True)
        return self._load_plain(self._final(step), sh, entry["dtype"])

    def _read_leaf(self, step: int, name: str, entry: Dict[str, Any], *,
                   keep_encoded: bool = False, parallel: bool = True,
                   man_cache: Optional[Dict[int, Dict]] = None):
        """Reassemble one leaf from its shard spans (numpy; a delta shard
        through its chain), or return the leaf's single int8 payload
        encoded when ``keep_encoded``."""
        man_cache = {} if man_cache is None else man_cache
        shape = tuple(entry["shape"])
        shards = self._check_tiling(name, shape, entry["shards"])
        if keep_encoded and len(shards) == 1:
            raw = self._load_shard(step, name, entry, shards[0], man_cache,
                                   keep_encoded=True)
            return raw if isinstance(raw, _Encoded) else raw.reshape(shape)
        if parallel and len(shards) > 1:
            payloads = self._engine.read_many(
                [functools.partial(self._load_shard, step, name, entry, sh,
                                   man_cache) for sh in shards])
        else:
            payloads = [self._load_shard(step, name, entry, sh, man_cache)
                        for sh in shards]
        out: Optional[np.ndarray] = None
        for sh, payload in zip(shards, payloads):
            spans = sh["spans"]
            if not spans:  # scalar
                return payload.reshape(shape)
            if out is None:
                out = np.empty(shape, dtype=payload.dtype)
            sl = tuple(slice(a, b) for a, b in spans)
            out[sl] = payload.reshape(tuple(b - a for a, b in spans))
        if out is None:
            raise IOError(f"leaf {name!r} has no shards")
        return out.reshape(shape)

    def _read_region(self, step: int, name: str, entry: Dict[str, Any],
                     region, man_cache: Dict[int, Dict],
                     keep_encoded: bool = False):
        """The part ``region`` (``[start, stop)`` per dim) of one leaf,
        from only the stored shards that overlap it: numpy; or, with
        ``keep_encoded``, a ``_Region`` whose int8-coded shards are
        decoded on the target device."""
        shape = tuple(entry["shape"])
        shards = self._check_tiling(name, shape, entry["shards"])
        if not shape:
            return self._load_shard(step, name, entry, shards[0],
                                    man_cache).reshape(())
        extent = tuple(d - c for c, d in region)
        pieces = []
        for sh in shards:
            over = [(max(a, c), min(b, d))
                    for (a, b), (c, d) in zip(sh["spans"], region)]
            if any(lo >= hi for lo, hi in over):
                continue
            payload = self._load_shard(step, name, entry, sh, man_cache,
                                       keep_encoded=keep_encoded)
            src = tuple(slice(lo - a, hi - a) for (lo, hi), (a, _)
                        in zip(over, sh["spans"]))
            dst = tuple(slice(lo - c, hi - c) for (lo, hi), (c, _)
                        in zip(over, region))
            pieces.append((payload, tuple(b - a for a, b in sh["spans"]),
                           src, dst))
        if keep_encoded:
            return _Region(extent, pieces)
        want = entry["dtype"]
        out = np.empty(extent, dtype=(np.dtype("V2") if want == "bfloat16"
                                      else np.dtype(want)))
        for payload, ext, src, dst in pieces:
            out[dst] = payload.reshape(ext)[src]
        return out

    def _to_leaf(self, raw, entry: Dict[str, Any], device) -> Any:
        """A loaded leaf on its target: numpy when ``device`` is None, else
        a tensor on ``device``; an encoded int8 leaf is decoded there."""
        want = entry["dtype"]
        if isinstance(raw, _Region):
            out = torch.empty(raw.shape, dtype=_FROM_NAME[want],
                              device=device)
            for payload, ext, src, dst in raw.pieces:
                out[dst] = self._to_leaf(payload, entry, device).reshape(
                    ext)[src]
            return out
        if isinstance(raw, _Encoded):
            nb = int(raw.meta["blocks"])
            q = torch.from_numpy(raw.q).to(device or "cpu").view(
                torch.int8).reshape(nb, 256)
            scales = torch.from_numpy(raw.scales).to(device or "cpu").view(
                torch.float32)
            out = self._dcodec.decode(q, scales, tuple(raw.meta["shape"]))
            out = out.to(_FROM_NAME[want])
            return out if device is not None else _to_numpy(out)
        if device is None:
            return raw
        return _from_numpy(raw, want, device)

    def restore(self, *, step: Optional[int] = None, like=None,
                shardings=None) -> Tuple[Any, Optional[Dict]]:
        """Returns (state, local_state).

        ``like``: template tree defining the structure; each restored leaf
        lands on the device of its template tensor (numpy where the
        template leaf is not a tensor).  With ``like=None`` the tree is
        rebuilt from the dotted names, as CPU tensors.  ``shardings``: a
        matching tree of ``NamedSharding`` (or None): such a leaf comes
        back as the calling rank's shard, on its mesh's device, whatever
        mesh wrote the checkpoint.  Restoring resets the delta base: the
        next ``save`` is a full checkpoint."""
        # join (without consuming its error) an in-flight async writer
        # first: its completion updates the delta base, which must not
        # outlive the reset below
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        merged = self._load_manifests(step)
        if like is None:
            names = list(merged)
            devices = [torch.device("cpu")] * len(names)
        else:
            named = flatten_named(like)
            for name, _ in named:
                if name not in merged:
                    raise KeyError(f"leaf {name!r} missing from checkpoint "
                                   f"{self._final(step)}")
            names = [n for n, _ in named]
            # a "meta" template gives shapes only: its leaves land on CPU
            devices = [(leaf.device if leaf.device.type != "meta"
                        else torch.device("cpu"))
                       if isinstance(leaf, torch.Tensor) else None
                       for _, leaf in named]
        shards = [None] * len(names)
        if shardings is not None:
            from repro_torch.tree import leaves
            shards = leaves(shardings)
            if len(shards) != len(names):
                raise ValueError(f"{len(shards)} shardings for "
                                 f"{len(names)} leaves")
            for i, sh in enumerate(shards):
                if sh is not None:
                    devices[i] = torch.device(sh.mesh.device or devices[i]
                                              or "cpu")
        keep = self._dcodec is not None
        man_cache: Dict[int, Dict] = {step: merged}
        fns = []
        for n, d, sh in zip(names, devices, shards):
            if sh is not None and merged[n]["shape"]:
                fns.append(functools.partial(
                    self._read_region, step, n, merged[n],
                    sh.spans(merged[n]["shape"]), man_cache,
                    keep_encoded=keep))
            else:
                fns.append(functools.partial(
                    self._read_leaf, step, n, merged[n],
                    keep_encoded=keep and d is not None, parallel=False,
                    man_cache=man_cache))
        raws = self._engine.read_many(fns)
        leaves = [self._to_leaf(r, merged[n], d)
                  for r, n, d in zip(raws, names, devices)]
        if like is None:
            state: Dict[str, Any] = {}
            for name, leaf in zip(names, leaves):
                parts = name.split(".")
                d = state
                for p in parts[:-1]:
                    d = d.setdefault(p, {})
                d[parts[-1]] = leaf
        else:
            state = unflatten(like, leaves)
        local = None
        lp = os.path.join(self._final(step), f"local_h{self.host_id}.json")
        if os.path.exists(lp):
            local = read_json(lp)
        # a restore is a rollback: the next save must not reference steps
        # from before it as delta parents
        self._delta_base = {}
        self._chain_len = 0
        return state, local

    def restore_local_shards(self, step: int) -> List[Dict]:
        """Every per-shard local-scope file of ``step``, by shard index."""
        final = self._final(step)
        found = []
        for fn in os.listdir(final):
            m = _LOCAL_SHARD_RE.match(fn)
            if m:
                found.append((int(m.group(1)), os.path.join(final, fn)))
        found.sort()
        return self._engine.read_many(
            [functools.partial(read_json, p) for _, p in found])

    def restore_latest(self, *, like=None, shardings=None,
                       candidates: Optional[List[int]] = None,
                       with_local_shards: bool = False
                       ) -> Tuple[Any, ...]:
        """Restore the newest checkpoint that actually verifies, walking
        back past corrupt ones (CRC mismatch, truncated shard, unreadable
        or incomplete manifest).  Returns (state, local_state, step,
        skipped) — or, with ``with_local_shards``, (state, local_state,
        shard_dicts, step, skipped); ``skipped`` lists (step, reason) for
        every checkpoint passed over."""
        if candidates is None:
            candidates = list(reversed(self.all_steps()))
        skipped: List[Tuple[int, str]] = []
        for s in candidates:
            try:
                state, local = self.restore(step=s, like=like,
                                            shardings=shardings)
                if with_local_shards:
                    shard_dicts = self.restore_local_shards(s)
                    return state, local, shard_dicts, s, skipped
                return state, local, s, skipped
            except (IOError, ValueError, json.JSONDecodeError) as e:
                # NOT KeyError: a template leaf missing from the manifest
                # is a caller bug that affects every candidate identically
                skipped.append((s, f"{type(e).__name__}: {e}"))
        detail = "; ".join(f"step {s}: {r}" for s, r in skipped)
        raise FileNotFoundError(
            f"no restorable checkpoint under {self.directory}"
            + (f" (skipped {detail})" if detail else ""))
