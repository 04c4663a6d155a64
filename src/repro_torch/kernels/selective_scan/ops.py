"""Public selective-scan entry: the plain version for CPU tensors, the
CUDA kernel for CUDA tensors.  Inputs are taken in float32 (as the
reference's ``ops.selective_scan`` casts them); B and C may be column
slices of the ``x_proj`` output, read in place."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.selective_scan.kernel import selective_scan_kernel
from repro_torch.kernels.selective_scan.ref import selective_scan_ref


def selective_scan(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 scan.  x, dt: (B, S, Di); bm, cm: (B, S, N); a: (Di, N);
    h0: (B, Di, N).  Returns (y, h_last), both float32."""
    if x.device.type == "cpu":
        return selective_scan_ref(x, dt, bm, cm, a, h0)
    f32 = torch.float32
    return selective_scan_kernel(
        x.to(f32).contiguous(), dt.to(f32).contiguous(), bm.to(f32),
        cm.to(f32), a.to(f32).contiguous(), h0.to(f32).contiguous())
