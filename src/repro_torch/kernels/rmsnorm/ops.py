"""Public RMSNorm entry (arbitrary leading dims): the plain version for a
CPU tensor, the CUDA kernels for a CUDA tensor.  Where autograd needs a
gradient (the train step), the forward kernel runs inside
``RMSNormFunction`` and its backward is the backward kernel.  Meta
tensors (a traced step: ``kernels/meta.py``) get the kernels' outputs,
empty, and launch nothing."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rms_norm_2d, rms_norm_2d_bwd
from repro_torch.kernels.rmsnorm.ref import rms_norm_ref


class RMSNormFunction(torch.autograd.Function):
    """``rms_norm_2d`` with the backward kernel as its gradient; the
    forward saves each row's float32 ``rsqrt(mean(x^2) + eps)``."""

    @staticmethod
    def forward(ctx, x, w, eps):
        if x.device.type == "meta":
            from repro_torch.kernels import meta

            y, rstd = meta.rmsnorm_fwd(x, w, True)
        else:
            rstd = torch.empty(x.shape[0], dtype=torch.float32,
                               device=x.device)
            y = rms_norm_2d(x, w, eps=eps, rstd=rstd)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, rstd = ctx.saved_tensors
        if x.device.type == "meta":
            from repro_torch.kernels import meta

            dx, dw = meta.rmsnorm_bwd(g.contiguous(), x, w, rstd)
        else:
            dx, dw = rms_norm_2d_bwd(g.contiguous(), x, w, rstd)
        return dx, dw, None


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, fp32 math, cast back to x's dtype; the
    weight arrives in x's dtype."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, w, eps)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNormFunction.apply(x2.contiguous(), w, eps).reshape(shape)
    if x.device.type == "meta":
        from repro_torch.kernels import meta

        return meta.rmsnorm_fwd(x2, w, False)[0].reshape(shape)
    return rms_norm_2d(x2, w, eps=eps).reshape(shape)
