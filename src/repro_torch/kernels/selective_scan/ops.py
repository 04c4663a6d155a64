"""Public selective-scan entries: the plain versions for CPU tensors, the
CUDA kernels for CUDA tensors.  Inputs are taken in float32 (as the
reference's ``ops.selective_scan`` casts them); B and C may be column
slices of the ``x_proj`` output, read in place.  The scan runs inside
``SelectiveScanFunction``, whose backward is ``selective_scan_bwd``; it
records a graph only where autograd records (the train step).  Meta
tensors (a traced step: ``kernels/meta.py``) get the kernels' outputs,
empty, and launch nothing."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.selective_scan.kernel import (
    selective_scan_bwd_kernel, selective_scan_kernel)
from repro_torch.kernels.selective_scan.ref import (selective_scan_bwd_ref,
                                                    selective_scan_ref)

_F32 = torch.float32


def _scan(x, dt, bm, cm, a, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return selective_scan_ref(x, dt, bm, cm, a, h0)
    if x.device.type == "meta":
        from repro_torch.kernels import meta

        return meta.scan_fwd(x, dt, bm, cm, a, h0)
    return selective_scan_kernel(
        x.to(_F32).contiguous(), dt.to(_F32).contiguous(), bm.to(_F32),
        cm.to(_F32), a.to(_F32).contiguous(), h0.to(_F32).contiguous())


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                       cm: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                       dy: torch.Tensor,
                       dh_last: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """The scan's backward: gradients (dx, ddt, dB, dC, dA, dh0) of (y,
    h_last) against ``dy`` and ``dh_last`` (``None`` = 0), float32."""
    if x.device.type == "cpu":
        return selective_scan_bwd_ref(x, dt, bm, cm, a, h0, dy, dh_last)
    if x.device.type == "meta":
        from repro_torch.kernels import meta

        return tuple(meta.scan_bwd(x, dt, bm, cm, a, h0, dy, dh_last))
    return selective_scan_bwd_kernel(
        x.to(_F32).contiguous(), dt.to(_F32).contiguous(), bm.to(_F32),
        cm.to(_F32), a.to(_F32).contiguous(), h0.to(_F32).contiguous(),
        dy.to(_F32).contiguous(),
        None if dh_last is None else dh_last.to(_F32).contiguous())


class SelectiveScanFunction(torch.autograd.Function):
    """The scan with ``selective_scan_bwd`` as its gradient; the backward
    recomputes the states from the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, bm, cm, a, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, bm, cm, a, h0)
        return _scan(x, dt, bm, cm, a, h0)

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, bm, cm, a, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=_F32, device=x.device)
        return selective_scan_bwd(x, dt, bm, cm, a, h0, dy, dh_last)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 scan.  x, dt: (B, S, Di); bm, cm: (B, S, N); a: (Di, N);
    h0: (B, Di, N).  Returns (y, h_last), both float32; differentiable in
    every input when autograd records."""
    return SelectiveScanFunction.apply(x, dt, bm, cm, a, h0)
