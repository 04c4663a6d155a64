"""Public block-hash entry: arbitrary leaves -> per-block uint32 hashes
on the host.  A CPU tensor takes the plain version, a CUDA tensor the
kernel; anything else raises.

``host_block_hashes`` is the one entry, of delta saves and of the
scrubber alike: every CUDA leaf of one device is hashed in ONE launch
(the reference's single jitted dispatch of ``batched_block_hashes``) and
the hashes come to the host in ONE copy."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.block_hash.kernel import hash_leaves
from repro_torch.kernels.block_hash.ref import (BLOCK_ELEMS,
                                                block_hashes_ref)

__all__ = ["BLOCK_ELEMS", "host_block_hashes"]


def _hashed(leaves: Sequence[torch.Tensor], block_elems: int
            ) -> List[Tuple[torch.Tensor, int, int]]:
    """Per leaf (hashes, start, count): a CPU leaf its own plain-version
    tensor, a CUDA leaf a span of its device's one launch."""
    out: List[Tuple[torch.Tensor, int, int]] = [None] * len(leaves)
    by_dev: Dict[torch.device, List[int]] = {}
    for i, x in enumerate(leaves):
        if x.device.type == "cpu":
            h = block_hashes_ref(x, block_elems)
            out[i] = (h, 0, h.numel())
        else:
            by_dev.setdefault(x.device, []).append(i)
    for idx in by_dev.values():
        h, spans = hash_leaves([leaves[i] for i in idx], block_elems)
        for i, (start, n) in zip(idx, spans):
            out[i] = (h, start, n)
    return out


def host_block_hashes(leaves: Sequence[torch.Tensor],
                      block_elems: int = BLOCK_ELEMS) -> List[np.ndarray]:
    """Block hashes of many leaves as uint32 numpy arrays: the plain
    version for CPU leaves; one kernel launch and one device-to-host copy
    per CUDA device for all of that device's leaves."""
    host: Dict[int, np.ndarray] = {}
    out = []
    for h, s, n in _hashed(leaves, block_elems):
        if id(h) not in host:
            host[id(h)] = h.cpu().numpy().view(np.uint32)
        out.append(host[id(h)][s:s + n])
    return out
