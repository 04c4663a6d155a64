"""Leaf checksums for the state scrubber (the reference's
``sdc/checksum.py``).

A tensor leaf's checksum is the uint32 sum of its block hashes
(``kernels/block_hash``): on the card, the CUDA kernel reduces every leaf
of a call in one launch and one copy brings the hash vectors to the host,
so no leaf data leaves the device; a CPU tensor takes the plain version.
A single flipped bit changes one word by +-2^k, hence its block hash by an
odd multiple of 2^k that cannot cancel mod 2^32: every single-bit upset is
caught.  The hash is the one delta checkpoints use, so scrub and delta
share one reduction.  A numpy leaf takes ``crc32_array`` (core/io_engine).
Either way a leaf's checksum is a plain int, stable across recomputation
on identical bytes, and equal to the reference's for the same leaf."""
from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch.kernels.block_hash.ops import host_block_hashes
from repro_torch.tree import flatten_named


def _host_crc(leaf) -> int:
    # deferred: repro_torch.core's facade imports repro_torch.sdc
    from repro_torch.core.io_engine import crc32_array

    return crc32_array(np.ascontiguousarray(leaf))


def leaf_checksum(leaf: Any) -> int:
    """Checksum one leaf; tensors reduce on their own device."""
    return checksums([leaf])[0]


def checksums(leaves: List[Any]) -> List[int]:
    """Checksum many leaves: one kernel launch and one copy to the host
    for all the leaves of a CUDA device, the plain version for CPU
    tensors, crc32 for numpy leaves."""
    out: List[Any] = [None] * len(leaves)
    idx = [i for i, v in enumerate(leaves) if isinstance(v, torch.Tensor)]
    if idx:
        hashes = host_block_hashes([leaves[i] for i in idx])
        for i, h in zip(idx, hashes):
            out[i] = int(h.sum(dtype=np.uint32))
    for i, v in enumerate(leaves):
        if out[i] is None:
            out[i] = _host_crc(np.asarray(v))
    return out


def named_leaves(tree) -> List[Tuple[str, Any]]:
    """(dotted-name, leaf) pairs: the checkpoint manifest's naming, so a
    scrubber hit, a bit-flip schedule and a checkpoint leaf all refer to
    the same thing."""
    return flatten_named(tree)
