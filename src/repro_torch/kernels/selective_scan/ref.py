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
