"""Plain versions of the block hash: on tensors (what the CUDA kernel of
``csrc/block_hash.cu`` is held against, and what a CPU tensor takes) and
on numpy arrays (the host-shard hasher), the arithmetic of the
reference's ``kernels/block_hash/ops.py`` and ``ref.py``.

A leaf is viewed as a flat run of 32-bit storage words: 4-byte dtypes
give their words, 2-byte and 1-byte dtypes zero-extend, 8-byte dtypes
give two words an element, low word first (numpy's ``view(np.uint32)``).
Block b holds words [b W, (b + 1) W), W = ``block_elems`` x words an
element, the ragged tail zero-filled; its hash is sum_j word_j (2j + 1)
mod 2^32.  The odd weights catch every single-bit flip (a flip changes
one word by +-2^k, the hash by an odd multiple of 2^k) and break the
symmetry of a plain sum (two words trading places inside a block change
the hash), so a block whose hash is unchanged can be referenced by a
delta checkpoint.  A leaf's checksum is the uint32 sum of its block
hashes: scrub and delta share one pass.

On tensors the products and sums run in int64, masked to 32 bits: torch
has no uint32 arithmetic on every device, and ``sum`` of int32 widens to
int64.  Hashes come back as int32 tensors holding the uint32 bits
(``.numpy().view(np.uint32)`` gives the reference's values)."""
from __future__ import annotations

import numpy as np
import torch

BLOCK_ELEMS = 65536   # default block: 64 Ki elements (256 KiB fp32)
_MASK = 0xFFFFFFFF


def words_per_element(dtype) -> int:
    """How many 32-bit words one element contributes in ``words_view``."""
    size = (dtype.itemsize if isinstance(dtype, torch.dtype)
            else np.dtype(dtype).itemsize)
    return 2 if size == 8 else 1


def words_view(x: torch.Tensor) -> torch.Tensor:
    """Flat int64 tensor of ``x``'s storage words, each in [0, 2^32)."""
    flat = x.contiguous().reshape(-1)
    size = flat.element_size()
    if size == 1:
        return flat.view(torch.uint8).to(torch.int64)
    if size == 2:
        return flat.view(torch.int16).to(torch.int64) & 0xFFFF
    return flat.view(torch.int32).to(torch.int64) & _MASK


def _to_int32_bits(h: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)


def block_hashes_ref(x: torch.Tensor,
                     block_elems: int = BLOCK_ELEMS) -> torch.Tensor:
    """x: any shape/dtype -> (NB,) int32 hash bits, NB = ceil(numel /
    block_elems), on x's device."""
    w = words_view(x)
    width = block_elems * words_per_element(x.dtype)
    pad = (-w.numel()) % width
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
    weights = 2 * torch.arange(width, dtype=torch.int64, device=w.device) + 1
    prod = (w.reshape(-1, width) * weights) & _MASK
    return _to_int32_bits(prod.sum(dim=1) & _MASK)


def checksum_ref(x: torch.Tensor, block_elems: int = BLOCK_ELEMS) -> int:
    """A leaf's checksum: the uint32 sum of its block hashes."""
    return int(block_hashes_ref(x, block_elems).to(torch.int64).sum()
               ) & _MASK


# ---------------------------------------------------------------------------
# numpy (host shards)
# ---------------------------------------------------------------------------

def words_np(arr: np.ndarray) -> np.ndarray:
    """Flat uint32 view of the array's storage words."""
    a = np.ascontiguousarray(arr).reshape(-1)
    size = a.dtype.itemsize
    if size % 4 == 0:
        return a.view(np.uint32)            # 4-byte: 1 word; 8-byte: 2 words
    if size == 2:
        return a.view(np.uint16).astype(np.uint32)
    return a.view(np.uint8).astype(np.uint32)


def block_hashes_np(arr: np.ndarray,
                    block_elems: int = BLOCK_ELEMS) -> np.ndarray:
    """(NB,) uint32 block hashes of a numpy array."""
    w = words_np(arr)
    wpe = 2 if arr.dtype.itemsize == 8 else 1
    width = block_elems * wpe
    pad = (-w.size) % width
    if pad:
        w = np.pad(w, (0, pad))
    weights = (2 * np.arange(width, dtype=np.uint32) + 1)[None, :]
    # uint32 multiply/accumulate wraps mod 2^32 silently: exactly the hash
    return (w.reshape(-1, width) * weights).sum(axis=1, dtype=np.uint32)

