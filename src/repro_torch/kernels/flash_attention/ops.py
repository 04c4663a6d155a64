"""Public flash-attention entry, (B, S, H, hd) layout: the plain version
for CPU tensors, the CUDA kernels for CUDA tensors.  Where autograd needs
a gradient (the train step), the forward kernel runs inside
``FlashAttentionFunction``, saving its log-sum-exp, and the backward is
the backward kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bshd, flash_attention_bshd_bwd)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


class FlashAttentionFunction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        o, lse = flash_attention_bshd(q, k, v, causal=causal, window=window,
                                      softcap=softcap, scale=scale, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bshd_bwd(q, k, v, o, do.contiguous(),
                                              lse, **ctx.kw)
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
        return FlashAttentionFunction.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), causal, window,
            softcap, scale)
    return flash_attention_bshd(q, k, v, causal=causal, window=window,
                                softcap=softcap, scale=scale)
