"""Plain PyTorch versions of paged decode attention.

``paged_attention_ref`` is the reference engine's off-TPU path
(``_ref_path``): gather each request's pages into its contiguous logical
cache, then the slot pool's ``decode_mha`` with ``cache_pos = arange``.
Page id 0 is the null page: table entries past a request's length point
at it and are masked by the length bound.  ``ops.py`` sends CPU tensors
here.

``paged_split_partials`` and ``combine_splits`` are a plain model of the
CUDA kernel's arithmetic (``csrc/paged_attention.cu``): each row's
positions are cut into fixed splits of ``split_positions(hd, dtype)``
positions counted from position 0; each live split gives an fp32 triple
(m, l, acc) over its attended positions, and the fold takes a row's live
splits in ascending order and divides by l once.  The tests hold it to
the JAX package; nothing on the serving path calls it."""
from __future__ import annotations

import torch

from repro_torch.layers.attention import decode_mha


def split_positions(hd: int, dtype: torch.dtype) -> int:
    """C, the positions of one split: about 8 KB of K rows (hd elements of
    the dtype each), a power of two from 16 to 256 — 32 at hd 128 in
    bf16, so a kernel block copies four 16-byte chunks of K and four of V
    a thread.  A function of hd and the dtype alone, never of R, the
    table, the row or the card, so a row's splits, and its bits, do not
    depend on them."""
    row = hd * torch.empty((), dtype=dtype).element_size()
    c = 16
    while c < 256 and 2 * c * row <= 8192:
        c *= 2
    return c


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


def paged_split_partials(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_tables: torch.Tensor,
                         lengths: torch.Tensor, *, window: int = 0,
                         softcap: float = 0.0, scale=None):
    """Each split's fp32 triple, as the split pass computes it.  q: (R, 1,
    H, hd); pages (P, ps, K, hd).  Returns m, l (R, K, NS, G), acc (R, K,
    NS, G, hd) and live (R, NS), NS = ceil(MPR * ps / C).  A dead split's
    m is -inf and its l and acc are 0; the fold never reads them."""
    R, _, H, hd = q.shape
    _, ps, K, _ = k_pages.shape
    MPR = page_tables.shape[1]
    G = H // K
    C = split_positions(hd, q.dtype)
    T = MPR * ps
    NS = -(-T // C)
    scale = scale if scale else hd ** -0.5
    # q scaled in fp32, as the kernel and the Pallas kernel scale it
    qf = q[:, 0].float().reshape(R, K, G, hd) * scale
    idx = page_tables.long()

    def gather(pages):              # (R, NS * C, K, hd), zero past T
        x = pages[idx].reshape(R, T, K, hd).float()
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, NS * C - T))

    kc, vc = gather(k_pages), gather(v_pages)
    s = torch.einsum("rkgd,rtkd->rkgt", qf, kc)
    if softcap and softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    # the attended positions [lo, hi]: the window's start, and the query's
    # position clamped to the table's reach
    cur = lengths.long()
    lo = (torch.clamp(cur - window + 1, min=0) if window and window > 0
          else torch.zeros_like(cur))
    hi = torch.clamp(cur, max=T - 1)
    pos = torch.arange(NS * C, device=q.device)
    ok = (pos >= lo[:, None]) & (pos <= hi[:, None])          # (R, NS*C)
    ok5 = ok.reshape(R, 1, 1, NS, C)
    s = s.reshape(R, K, G, NS, C)
    m = torch.where(ok5, s, -torch.inf).amax(-1)             # (R, K, G, NS)
    p = torch.where(ok5, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("rkgsc,rsckd->rkgsd", p,
                       vc.reshape(R, NS, C, K, hd))
    live = ok.reshape(R, NS, C).any(-1)
    return (m.permute(0, 1, 3, 2), l.permute(0, 1, 3, 2),
            acc.permute(0, 1, 3, 2, 4), live)


def combine_splits(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                   live: torch.Tensor) -> torch.Tensor:
    """The fold: m, l (R, K, NS, G), acc (R, K, NS, G, hd), live (R, NS)
    -> (R, K, G, hd) fp32.  A row's live splits are taken in ascending
    order (a dead split is skipped: whatever it holds adds nothing), then
    acc is divided by l once."""
    lv = live[:, None, :, None]                               # (R,1,NS,1)
    mx = torch.where(lv, m, -torch.inf).amax(2)               # (R, K, G)
    l_tot = torch.zeros_like(mx)
    a_tot = torch.zeros_like(acc[:, :, 0])
    for s in range(m.shape[2]):
        on = live[:, s][:, None, None]                        # (R, 1, 1)
        wgt = torch.exp(m[:, :, s] - mx)
        l_tot = torch.where(on, l_tot + l[:, :, s] * wgt, l_tot)
        a_tot = torch.where(on[..., None],
                            a_tot + acc[:, :, s] * wgt[..., None], a_tot)
    return a_tot / torch.clamp(l_tot, min=1e-30)[..., None]


def paged_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              page_tables: torch.Tensor,
                              lengths: torch.Tensor, *, window: int = 0,
                              softcap: float = 0.0,
                              scale=None) -> torch.Tensor:
    """The split model end to end: (R, 1, H, hd) in q's dtype."""
    m, l, acc, live = paged_split_partials(
        q, k_pages, v_pages, page_tables, lengths, window=window,
        softcap=softcap, scale=scale)
    o = combine_splits(m, l, acc, live)
    return o.reshape(q.shape).to(q.dtype)
