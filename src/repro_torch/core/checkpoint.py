"""Atomic checkpoint manager over trees of tensors: the reference's
``core/checkpoint.py`` full-save path, writing and reading the same
format, so a checkpoint written by either package restores in the other.

Layout (one directory per step):

    <dir>/step_00000420/
        manifest_h<i>.json          global shapes/dtypes/codec/CRCs
        <leaf-name>.s<i>_<k>.npy    shard k of that leaf (.npy payload)
        local_h<i>.json             per-host local state
        local_s<k>.json             per-shard local state (optional)
        ack_h<i>                    per-host completion marker
    <dir>/step_00000420.tmp.<pid>   staging dir, atomically renamed

Leaf names are the reference's dotted paths (``tree.flatten_named``:
dict keys sorted).  Commit protocol: every host writes shards + ack into
the staging dir; host 0 renames it into place once all acks are present
(single-process runs commit immediately).  A reader only trusts
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
   4x fewer bytes to the device, the same bits as the host decode).

Async mode: ``save(..., blocking=False)`` snapshots to host memory and
hands serialization to a writer thread (double-buffered: a new save
drains the previous one; ``wait()`` re-raises writer errors).

Delta checkpoints (dirty blocks by on-device hashes) wait for the next
slice of the port (ROADMAP item 5), as do restores onto other shardings
(item 10).
"""
from __future__ import annotations

import functools
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.codec import CODECS, Codec, DeviceCodec
from repro_torch.core.io_engine import (ShardIOEngine, crc32_array,
                                        fsync_path, pid_alive, read_json,
                                        write_json, write_npy)
from repro_torch.tree import flatten_named, unflatten

_STEP_RE = re.compile(r"^step_(\d{8})$")
_STAGING_RE = re.compile(r"^step_(\d{8})\.tmp\.(\d+)$")
_LOCAL_SHARD_RE = re.compile(r"^local_s(\d{5})\.json$")

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


class _Encoded:
    """A verified int8 payload (q blocks followed by fp32 scales) kept
    encoded so that it is decoded on its target device."""

    def __init__(self, payload: np.ndarray, meta: Dict[str, Any]):
        self.payload = payload
        self.meta = meta


class SaveStats:
    def __init__(self, step, bytes_written, snapshot_s, write_s, blocking):
        self.step = step
        self.bytes_written = bytes_written
        self.snapshot_seconds = snapshot_s
        self.write_seconds = write_s
        self.blocking = blocking

    def __repr__(self):
        return (f"SaveStats(step={self.step}, MB={self.bytes_written/1e6:.1f},"
                f" snapshot={self.snapshot_seconds:.3f}s,"
                f" write={self.write_seconds:.3f}s, blocking={self.blocking})")


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
                 delta: bool = False):
        if delta:
            raise NotImplementedError(
                "delta checkpoints wait for the block_hash slice of the "
                "port (ROADMAP item 5)")
        self.directory = directory
        self.host_id = host_id
        self.num_hosts = num_hosts
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
        self._my_staging: Set[str] = set()
        os.makedirs(directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._writer_err: Optional[BaseException] = None
        self._sweep_stale_staging()

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def _staging(self, step: int) -> str:
        return os.path.join(self.directory,
                            f"step_{step:08d}.tmp.{os.getpid()}")

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
            if pid != os.getpid() and pid_alive(pid):
                continue
            shutil.rmtree(path, ignore_errors=True)

    def _dcodec_ok(self, data) -> bool:
        return (self._dcodec is not None and isinstance(data, torch.Tensor)
                and data.is_floating_point() and data.numel() >= 1024)

    def _host_codec_ok(self, data: np.ndarray) -> bool:
        if self.codec is None:
            return False
        return data.dtype in (np.float32, np.float64) and data.size >= 1024

    def _snapshot(self, named) -> Tuple[List[Dict[str, Any]],
                                        Dict[str, Any]]:
        """Device -> host: the only cost on the BSP critical path in async
        mode.  With device_codec, eligible leaves are quantized on their
        device first (every kernel is enqueued before the first copy), so
        only int8 + scales cross the link.

        Returns (shard_plan, manifest_arrays); each plan item owns its
        manifest shard-meta dict (the writer adds codec/crc info)."""
        plan: List[Dict[str, Any]] = []
        manifest_arrays: Dict[str, Any] = {}
        pending: List[Tuple[Dict[str, Any], Any]] = []
        for name, value in named:
            shape = list(value.shape) if hasattr(value, "shape") else []
            fname = f"{name}.s{self.host_id}_0.npy"
            smeta: Dict[str, Any] = {"file": fname,
                                     "spans": [[0, d] for d in shape]}
            manifest_arrays[name] = {"shape": shape,
                                     "dtype": _dtype_name(value),
                                     "shards": [smeta]}
            item: Dict[str, Any] = {"fname": fname, "meta": smeta}
            if self._dcodec_ok(value):
                q, s = self._dcodec.encode(value)
                smeta["codec"] = {"name": self.codec_name,
                                  **DeviceCodec.block_meta(tuple(shape))}
                item["kind"] = "parts"
                pending.append((item, (q, s)))
            else:
                item["kind"] = "host"
                pending.append((item, value))
            plan.append(item)
        for item, value in pending:
            if item["kind"] == "parts":
                item["parts"] = [_to_numpy(t) for t in value]
            else:
                data = (_to_numpy(value) if isinstance(value, torch.Tensor)
                        else np.asarray(value))
                item["data"] = data
                item["codec_ok"] = self._host_codec_ok(data)
        return plan, manifest_arrays

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
             blocking: bool = True) -> SaveStats:
        """``local_state``: this host's local-scope dict (one file per host).
        ``local_shards``: one dict per DP shard, each written as its own
        ``local_s<k>.json``."""
        self.wait()  # double-buffer: drain previous async write
        t0 = time.perf_counter()
        named = flatten_named(state)
        shard_plan, manifest_arrays = self._snapshot(named)
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
                    "kind": "full",
                    "arrays": manifest_arrays,
                }
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
                for k, sd in enumerate(local_shards or ()):
                    idx = int(sd.get("shard", k))
                    spath = os.path.join(staging, f"local_s{idx:05d}.json")
                    paths.append(write_json(spath, sd))
                apath = os.path.join(staging, f"ack_h{self.host_id}")
                open(apath, "w").close()
                paths.append(apath)
                self._engine.finalize(staging, paths)
                # commit when all hosts acked (single-process: immediately)
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
            return total_b, time.perf_counter() - t1

        if blocking:
            total_b, write_s = write()
            return SaveStats(step, total_b, snapshot_s, write_s, True)

        stats = SaveStats(step, 0, snapshot_s, 0.0, False)

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

    def _gc(self) -> None:
        """Prune beyond ``keep`` (full saves reference no parent)."""
        steps = self.all_steps()
        if self.keep:
            for s in steps[:-self.keep]:
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

    def _load_manifests(self, step: int) -> Dict[str, Any]:
        final = self._final(step)
        merged: Dict[str, Any] = {}
        for h in range(self.num_hosts):
            p = os.path.join(final, f"manifest_h{h}.json")
            if not os.path.exists(p):
                continue
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
        if sh.get("delta"):
            raise IOError(f"shard {sh.get('file')} is a delta save: delta "
                          "restores wait for ROADMAP item 5")
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
                return _Encoded(payload, sh["codec"])
            payload = CODECS[sh["codec"]["name"]].decode(payload, sh["codec"])
        if want == "bfloat16":
            return payload             # raw 2-byte void, viewed on load
        return payload.astype(np.dtype(want), copy=False)

    def _read_leaf(self, step: int, name: str, entry: Dict[str, Any], *,
                   keep_encoded: bool = False, parallel: bool = True):
        """Reassemble one leaf from its shard spans (numpy), or return the
        leaf's single int8 payload encoded when ``keep_encoded``."""
        shape = tuple(entry["shape"])
        want = entry["dtype"]
        shards = self._check_tiling(name, shape, entry["shards"])
        final = self._final(step)
        if keep_encoded and len(shards) == 1 and "codec" in shards[0]:
            return self._decode_payload(final, shards[0], want,
                                        keep_encoded=True)
        if parallel and len(shards) > 1:
            payloads = self._engine.read_many(
                [functools.partial(self._decode_payload, final, sh, want)
                 for sh in shards])
        else:
            payloads = [self._decode_payload(final, sh, want)
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

    def _to_leaf(self, raw, entry: Dict[str, Any], device) -> Any:
        """A loaded leaf on its target: numpy when ``device`` is None, else
        a tensor on ``device``; an encoded int8 leaf is decoded there."""
        want = entry["dtype"]
        if isinstance(raw, _Encoded):
            nb = int(raw.meta["blocks"])
            buf = torch.from_numpy(raw.payload).to(device or "cpu")
            q = buf[:nb * 256].view(torch.int8).reshape(nb, 256)
            scales = buf[nb * 256:].view(torch.float32)
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
        rebuilt from the dotted names, as CPU tensors."""
        if shardings is not None:
            raise NotImplementedError(
                "restore onto shardings waits for the elastic-mesh slice "
                "of the port (ROADMAP item 10)")
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
            devices = [leaf.device if isinstance(leaf, torch.Tensor)
                       else None for _, leaf in named]
        keep = self._dcodec is not None
        fns = [functools.partial(self._read_leaf, step, n, merged[n],
                                 keep_encoded=keep and d is not None,
                                 parallel=False) for n, d in
               zip(names, devices)]
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
