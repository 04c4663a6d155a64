"""Plain PyTorch version of the RMSNorm kernel (the reference's
``layers/norms.py`` formula, including ``reciprocal(sqrt(...))``)."""
from __future__ import annotations

import torch


def rms_norm_ref(x: torch.Tensor, w: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * w.float()).to(x.dtype)
