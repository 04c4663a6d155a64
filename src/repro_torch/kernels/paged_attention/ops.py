"""Public paged decode-attention entry, engine layout: the plain version
(gather + ``decode_mha``) for CPU tensors, the CUDA kernel for CUDA
tensors.  Pages use the serve layout (P, ps, K, hd) on both paths."""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.kernel import paged_attention_rhd
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_tables: torch.Tensor,
                           lengths: torch.Tensor, *, window: int = 0,
                           softcap: float = 0.0, scale=None) -> torch.Tensor:
    """q: (R, 1, H, hd); k_pages/v_pages: (P, ps, K, hd); page_tables:
    (R, MPR) int32; lengths: (R,) int32.  Returns (R, 1, H, hd)."""
    R, S, H, hd = q.shape
    if S != 1:
        raise ValueError("paged attention decodes one token per request")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_tables,
                                   lengths, window=window, softcap=softcap,
                                   scale=scale)
    o = paged_attention_rhd(q.reshape(R, H, hd), k_pages, v_pages,
                            page_tables, lengths, window=window,
                            softcap=softcap, scale=scale)
    return o.reshape(R, 1, H, hd)
