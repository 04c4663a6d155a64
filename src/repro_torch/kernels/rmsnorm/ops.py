"""Public RMSNorm entry (arbitrary leading dims): the plain version for a
CPU tensor, the CUDA kernel for a CUDA tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rms_norm_2d
from repro_torch.kernels.rmsnorm.ref import rms_norm_ref


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, fp32 math, cast back to x's dtype; the
    weight arrives in x's dtype (cast once at load)."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, w, eps)
    shape = x.shape
    return rms_norm_2d(x.reshape(-1, shape[-1]), w, eps=eps).reshape(shape)
