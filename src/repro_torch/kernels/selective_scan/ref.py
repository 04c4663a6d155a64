"""Plain PyTorch version of the selective-scan kernel: the direct
sequential recurrence of the reference's ``selective_scan_ref``."""
from __future__ import annotations

from typing import Tuple

import torch


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                       cm: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: (B, S, Di); bm, cm: (B, S, N); a: (Di, N); h0: (B, Di, N).
    ``h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) B_t``, ``y_t = C_t . h_t``.
    Returns (y (B, S, Di), h_last (B, Di, N)), both float32."""
    x, dt, bm, cm, a = (t.float() for t in (x, dt, bm, cm, a))
    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(dt[:, t, :, None] * a)             # (B, Di, N)
        h = decay * h + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cm[:, t]))
    if not ys:
        return x.new_zeros(x.shape), h
    return torch.stack(ys, dim=1), h


# The kernel's parts (warps) a channel's states are split over and time
# steps a ring stage (``kParts``, ``kT`` in csrc/selective_scan.cu), and
# log2(e) as the kernel rounds it (hopper.cuh's REPRO_LOG2E).
PARTS = 8
TILE = 32
LOG2E = 1.4426950408889634


def states_per_part(n: int, parts: int = PARTS) -> int:
    """A part's states: ceil(n / parts), rounded up to a power of two."""
    per = -(-n // parts)
    return 1 << (per - 1).bit_length()


def part_tree_ref(p: torch.Tensor) -> torch.Tensor:
    """The kernel's fold of the parts' partial sums of y (the last axis):
    the upper half added to the lower half until one value is left,
    ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)) for 8."""
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return p[..., 0]


def selective_scan_parts_ref(x: torch.Tensor, dt: torch.Tensor,
                             bm: torch.Tensor, cm: torch.Tensor,
                             a: torch.Tensor, h0: torch.Tensor,
                             parts: int = PARTS
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's arithmetic in float32, for the CPU tests: the
    decay as exp2(dt * fl32(A log2 e)); the states split into ``parts``
    parts of ``states_per_part`` each (zero-padded past N); each part's
    partial sum of C h over its states in increasing n; the parts' sums
    folded by ``part_tree_ref``.  Same contract as
    ``selective_scan_ref``."""
    x, dt, bm, cm, a = (t.float() for t in (x, dt, bm, cm, a))
    B, S, Di = x.shape
    N = a.shape[-1]
    npl = states_per_part(N, parts)
    pad = (0, parts * npl - N)
    a2 = torch.nn.functional.pad(a, pad) * torch.tensor(LOG2E,
                                                        dtype=torch.float32)
    bm, cm = (torch.nn.functional.pad(t, pad) for t in (bm, cm))
    h = torch.nn.functional.pad(h0.float(), pad)
    ys = []
    for t in range(S):
        decay = torch.exp2(dt[:, t, :, None] * a2)            # (B, Di, P)
        h = decay * h + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
        prod = (cm[:, t, None, :] * h).reshape(B, Di, parts, npl)
        part = prod[..., 0]
        for j in range(1, npl):
            part = part + prod[..., j]
        ys.append(part_tree_ref(part))
    h = h[..., :N].contiguous()
    if not ys:
        return x.new_zeros(x.shape), h
    return torch.stack(ys, dim=1), h
