"""Public paged decode-attention entry, engine layout: the plain version
(gather + ``decode_mha``) for CPU tensors, the CUDA kernel for CUDA
tensors.  Pages use the serve layout (P, ps, K, hd) on both paths.

``row_decode_attention`` is decode against contiguous cache rows (the
slot pool, a lockstep batch cache): ``decode_mha`` over the rows' own
positions for CPU tensors; for CUDA tensors the same paged kernel over a
view of the rows as pages (``row_page_table``), so the slot pool's
decode keeps the paged pool's bits at equal shapes."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.paged_attention.kernel import paged_attention_rhd
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.layers.attention import decode_mha

#: positions a page of the row view holds, at most (the serve page size)
ROW_PAGE = 16


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


def row_page_table(rows: int, sc: int, cache_len: int,
                   device) -> Tuple[int, torch.Tensor]:
    """The page view of ``rows`` contiguous rows of ``sc`` slots: its page
    size ``ps`` (the largest divisor of ``sc`` up to ``ROW_PAGE``; 1
    divides any row) and its table (rows, ceil(cache_len / ps)) int32,
    whose entry p of row r is page ``r * (sc / ps) + p mod (sc / ps)``.
    A full-length row (sc = cache_len) gets the identity; a rolling row
    (sc = window < cache_len) wraps, so logical position t reads slot
    t mod sc, where the decode wrote it."""
    ps = math.gcd(sc, ROW_PAGE)
    per = sc // ps
    logical = torch.arange(-(-cache_len // ps), device=device) % per
    first = torch.arange(rows, device=device)[:, None] * per
    return ps, (first + logical[None, :]).to(torch.int32)


def row_decode_attention(q: torch.Tensor, k_rows: torch.Tensor,
                         v_rows: torch.Tensor, pos: torch.Tensor,
                         cur: torch.Tensor, *, cache_len: int,
                         window: int = 0, softcap: float = 0.0, scale=None,
                         table: Optional[Tuple[int, torch.Tensor]] = None
                         ) -> torch.Tensor:
    """q: (B, 1, H, hd); k_rows/v_rows: (B, sc, K, hd) with this step's
    k/v already written at slot ``cur % sc``; pos: (B, sc) int32, each
    slot's position (-1 empty); cur: (B,) int32, each query's position.
    ``table``: ``row_page_table``'s result, built here when None.
    Returns (B, 1, H, hd).

    On the card a row attends its logical positions 0..cur through the
    view (the window mask keeps out what a rolling row overwrote).  A
    query position at or past ``cache_len`` (an idle slot that kept
    decoding) is clamped to ``cache_len - 1`` so that it stays inside its
    table; an active row never gets there, and its bits are untouched."""
    if q.device.type == "cpu":
        return decode_mha(q, k_rows, v_rows, pos, cur, window=window,
                          softcap=softcap, scale=scale)
    B, sc = k_rows.shape[:2]
    ps, tbl = (table if table is not None
               else row_page_table(B, sc, cache_len, q.device))
    kp = k_rows.view(B * sc // ps, ps, *k_rows.shape[2:])
    vp = v_rows.view(B * sc // ps, ps, *v_rows.shape[2:])
    lengths = torch.clamp(cur, max=cache_len - 1).to(torch.int32)
    return paged_decode_attention(q, kp, vp, tbl, lengths, window=window,
                                  softcap=softcap, scale=scale)
