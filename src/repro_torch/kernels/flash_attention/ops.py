"""Public flash-attention entry, (B, S, H, hd) layout: the plain version
for CPU tensors, the CUDA kernels for CUDA tensors.  Where autograd needs
a gradient (the train step), the forward kernel runs inside
``FlashAttentionFunction``, saving its log-sum-exp, and the backward is
the backward kernel.  Meta tensors (a traced step: ``kernels/meta.py``)
get the kernels' outputs, empty, and launch nothing."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    check_backward_head_dim, flash_attention_bshd, flash_attention_bshd_bwd)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def _fwd(q, k, v, *, causal, window, softcap, scale, lse=False):
    if q.device.type == "meta":
        from repro_torch.kernels import meta

        o, lse_t = meta.flash_fwd(q, k, v, bool(causal), int(window or 0),
                                  lse)
        return (o, lse_t) if lse else o
    return flash_attention_bshd(q, k, v, causal=causal, window=window,
                                softcap=softcap, scale=scale, lse=lse)


def _bwd(q, k, v, o, do, lse, *, causal, window, softcap, scale):
    if q.device.type == "meta":
        from repro_torch.kernels import meta

        return meta.flash_bwd(q, k, v, o, do, lse, bool(causal),
                              int(window or 0))
    return flash_attention_bshd_bwd(q, k, v, o, do, lse, causal=causal,
                                    window=window, softcap=softcap,
                                    scale=scale)


class FlashAttentionFunction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        o, lse = _fwd(q, k, v, causal=causal, window=window,
                      softcap=softcap, scale=scale, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, o, do.contiguous(), lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale=None) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,Skv,K,hd) -> (B,S,H,hd), queries at positions
    0..S-1 (prefill and train; paged decode has its own kernel)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        check_backward_head_dim(q.shape[-1])
        return FlashAttentionFunction.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), causal, window,
            softcap, scale)
    return _fwd(q, k, v, causal=causal, window=window, softcap=softcap,
                scale=scale)
