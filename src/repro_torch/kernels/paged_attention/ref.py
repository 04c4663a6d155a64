"""Plain PyTorch version of paged decode attention: the reference
engine's off-TPU path (``_ref_path``) — gather each request's pages into
its contiguous logical cache, then the slot pool's ``decode_mha`` with
``cache_pos = arange``.  Page id 0 is the null page: table entries past a
request's length point at it and are masked by the length bound."""
from __future__ import annotations

import torch

from repro_torch.layers.attention import decode_mha


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_tables: torch.Tensor,
                        lengths: torch.Tensor, *, window: int = 0,
                        softcap: float = 0.0, scale=None) -> torch.Tensor:
    """q: (R, 1, H, hd); k_pages/v_pages: (P, ps, K, hd); page_tables:
    (R, MPR); lengths: (R,) — the query's position (it attends
    0..lengths[r]).  Returns (R, 1, H, hd)."""
    R = q.shape[0]
    _, ps, K, hd = k_pages.shape
    MPR = page_tables.shape[1]
    idx = page_tables.long()
    kc = k_pages[idx].reshape(R, MPR * ps, K, hd)
    vc = v_pages[idx].reshape(R, MPR * ps, K, hd)
    cache_pos = torch.arange(MPR * ps, dtype=torch.int32, device=q.device)
    return decode_mha(q, kc, vc, cache_pos, lengths, window=window,
                      softcap=softcap, scale=scale)
