"""Host wrapper of the CUDA block-hash kernel (``csrc/block_hash.cu``),
which replaces the TPU kernel ``repro/kernels/block_hash/kernel.py:
hash_rows``.  One launch hashes up to 120 leaves (the table of leaves is
a kernel parameter, ``repro_block_hash_max_leaves``); more take one
launch per that many."""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build.library()
    fn = lib.repro_block_hash
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_block_hash_max_leaves.restype = ctypes.c_int
    return fn, lib.repro_block_hash_max_leaves()


def hash_leaves(leaves: Sequence[torch.Tensor], block_elems: int
                ) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
    """Block hashes of many leaves on one CUDA device in one launch.

    Returns (hashes, spans): ``hashes`` a (total,) int32 tensor of the
    uint32 hash bits on the device, ``spans[i] = (start, count)`` leaf
    i's blocks in it (count = ceil(numel / block_elems), 0 for an empty
    leaf).  A leaf that is not contiguous is copied first: the kernel
    reads words in place, in ``reshape(-1)`` order."""
    if block_elems <= 0:
        raise ValueError(f"block_elems must be positive, got {block_elems}")
    if not leaves:
        raise ValueError("hash_leaves needs at least one leaf")
    dev = leaves[0].device
    if dev.type != "cuda" or any(t.device != dev for t in leaves):
        raise ValueError("hash_leaves runs on one CUDA device, got "
                         f"{sorted({str(t.device) for t in leaves})}")
    flat = [t.contiguous() for t in leaves]
    rows, spans, total = [], [], 0
    for t in flat:
        if t.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"hash_leaves takes 1-, 2-, 4- or 8-byte "
                            f"elements, got {t.dtype}")
        nb = -(-t.numel() // block_elems)
        spans.append((total, nb))
        if nb:
            rows.append([t.data_ptr(), t.numel(), t.element_size(), total])
        total += nb
    out = torch.empty(total, dtype=torch.int32, device=dev)
    if not total:
        return out, spans
    fn, per_launch = _entry()
    table = (ctypes.c_longlong * (4 * len(rows)))(
        *[v for r in rows for v in r])
    err = fn(ctypes.cast(table, ctypes.c_void_p), len(rows), block_elems,
             out.data_ptr(), build.stream_ptr(dev))
    build.check(err, "hash_leaves")
    hash_leaves.launches += -(-len(rows) // per_launch)
    return out, spans


hash_leaves.launches = 0
