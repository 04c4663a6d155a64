"""Parallel shard I/O engine: pooled writers/readers, batched fsync,
zero-copy CRC and streamed .npy writes.

The Young/Daly cost term C is dominated by moving checkpoint bytes — first
across the device->host link, then through the page cache to disk.  This
module removes the incidental copies and serialization points the naive
implementation pays on top of that:

- ``crc32_array``: CRC32 over ``memoryview`` chunks of the array buffer —
  no ``tobytes()`` materialization (which doubled peak memory and added a
  full copy per shard on both save and restore).
- ``write_npy``: streams one or more arrays into a single ``.npy`` file
  chunk by chunk, computing the payload CRC *in the same pass* over the
  same memoryview slices — one data traversal for write+checksum, zero
  intermediate buffers.  Multiple arrays are packed as one 1-D uint8
  payload (how the int8 codec lays out q-blocks followed by scales).
- ``ShardIOEngine``: a small ThreadPoolExecutor that encodes+writes shards
  concurrently and batches durability: files are written (and flushed)
  first, then fsynced together, then the directory is fsynced once —
  instead of a per-file write->fsync lockstep that serializes the disk
  queue.  ``fsync_mode``: "batch" (default), "per_file" (legacy lockstep),
  "none" (rely on the atomic rename only; fine for tests/tmpfs).
"""
from __future__ import annotations

import json
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np

CHUNK = 4 << 20  # 4 MiB streaming granule

FSYNC_MODES = ("batch", "per_file", "none")


def _byte_view(arr: np.ndarray) -> memoryview:
    """Flat uint8 memoryview of an array's buffer (copy only if the input
    is non-contiguous, which device_get outputs never are).  Goes through
    ndarray.view(uint8) rather than memoryview.cast("B"): the buffer
    protocol rejects ml_dtypes customs (bfloat16, fp8) but a uint8 view of
    the same memory is always legal."""
    a = np.ascontiguousarray(arr).reshape(-1)
    return memoryview(a.view(np.uint8))


def crc32_array(arr: np.ndarray, crc: int = 0, chunk: int = CHUNK) -> int:
    """CRC32 of the array's data bytes without a tobytes() copy."""
    mv = _byte_view(arr)
    for off in range(0, len(mv), chunk):
        crc = zlib.crc32(mv[off:off + chunk], crc)
    return crc & 0xFFFFFFFF


def write_npy(path: str, arrays, *, fsync: bool = False,
              chunk: int = CHUNK) -> Tuple[int, int]:
    """Stream array(s) to a ``.npy`` file; returns (payload_bytes, crc32).

    A single ndarray keeps its dtype/shape (np.save-compatible); a sequence
    is packed back-to-back as one 1-D uint8 payload.  The CRC covers the
    payload data bytes (not the header), matching ``crc32_array`` of the
    ``np.load``-ed result.
    """
    fmt = np.lib.format
    single = isinstance(arrays, np.ndarray)
    parts: Sequence[np.ndarray] = [arrays] if single else list(arrays)
    if single:
        a0 = np.ascontiguousarray(parts[0])
        parts = [a0]
        header = {"descr": fmt.dtype_to_descr(a0.dtype),
                  "fortran_order": False, "shape": a0.shape}
    else:
        total = sum(int(a.nbytes) for a in parts)
        header = {"descr": "|u1", "fortran_order": False, "shape": (total,)}
    crc = 0
    nbytes = 0
    with open(path, "wb") as f:
        fmt.write_array_header_1_0(f, header)
        for a in parts:
            mv = _byte_view(a)
            for off in range(0, len(mv), chunk):
                piece = mv[off:off + chunk]
                f.write(piece)
                crc = zlib.crc32(piece, crc)
            nbytes += len(mv)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    return nbytes, crc & 0xFFFFFFFF


def write_json(path: str, obj: Any, *, fsync: bool = False) -> str:
    """Write one JSON sidecar (manifest, local-scope shard state); returns
    ``path`` so callers can collect it for the batched-fsync barrier."""
    with open(path, "w") as f:
        json.dump(obj, f)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    return path


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def fsync_path(path: str) -> None:
    """fsync a file or directory by path (for batched / rename durability)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def pid_alive(pid: int) -> bool:
    """Is ``pid`` a live process?  Signal 0 probes without delivering;
    EPERM means alive-but-not-ours (a co-hosted writer under another uid).
    Used by the stale-staging sweep: a ``step_<n>.tmp.<pid>`` directory
    whose owner is dead will never be committed and can be reclaimed."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True


class ShardIOEngine:
    """ThreadPoolExecutor-backed shard writer/reader with batched fsync."""

    def __init__(self, threads: int = 0, fsync_mode: str = "batch"):
        if fsync_mode not in FSYNC_MODES:
            raise ValueError(f"fsync_mode {fsync_mode!r} not in {FSYNC_MODES}")
        self.threads = int(threads) if threads else min(
            8, max(2, os.cpu_count() or 2))
        self.fsync_mode = fsync_mode
        self._pool: ThreadPoolExecutor | None = None
        self._lock = threading.Lock()

    @property
    def per_file_fsync(self) -> bool:
        return self.fsync_mode == "per_file"

    def _get_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.threads, thread_name_prefix="ckpt-io")
            return self._pool

    def run_jobs(self, jobs: List[Callable[[], Tuple[str, int]]]
                 ) -> Tuple[int, List[str]]:
        """Run write jobs (each returns (path, nbytes)) concurrently.
        Returns (total_bytes, paths); the first job exception re-raises."""
        if len(jobs) <= 1:
            results = [j() for j in jobs]
        else:
            results = list(self._get_pool().map(lambda j: j(), jobs))
        return sum(n for _, n in results), [p for p, _ in results]

    def read_many(self, fns: List[Callable[[], np.ndarray]]) -> List:
        """Run read/decode callables concurrently, preserving order."""
        if len(fns) <= 1:
            return [fn() for fn in fns]
        return list(self._get_pool().map(lambda fn: fn(), fns))

    def finalize(self, directory: str, paths: List[str]) -> None:
        """Durability barrier: fsync written files (batch mode — per_file
        already synced them inline), then the directory entry, once."""
        if self.fsync_mode == "none":
            return
        if self.fsync_mode == "batch":
            if len(paths) > 1:
                list(self._get_pool().map(fsync_path, paths))
            else:
                for p in paths:
                    fsync_path(p)
        fsync_path(directory)

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)
