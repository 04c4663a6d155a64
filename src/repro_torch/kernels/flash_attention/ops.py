"""Public flash-attention entry, (B, S, H, hd) layout: the plain version
for CPU tensors, the CUDA kernel for CUDA tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_bshd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale=None) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,Skv,K,hd) -> (B,S,H,hd), queries at positions
    0..S-1 (prefill; paged decode has its own kernel)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    return flash_attention_bshd(q, k, v, causal=causal, window=window,
                                softcap=softcap, scale=scale)
