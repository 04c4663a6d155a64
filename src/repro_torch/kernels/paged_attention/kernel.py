"""Host wrapper of the CUDA paged decode-attention kernels
(``csrc/paged_attention.cu``: a pass over fixed position splits, then a
combine of each row's splits in ascending order), which replace the TPU
kernel ``repro/kernels/paged_attention/kernel.py:paged_attention_rkgd``."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import split_positions


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().repro_paged_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def paged_attention_rhd(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_tables: torch.Tensor,
                        lengths: torch.Tensor, *, window: int = 0,
                        softcap: float = 0.0, scale=None) -> torch.Tensor:
    """q: (R, H, hd); k_pages/v_pages: (P, ps, K, hd) (the serve layout,
    read in place); page_tables: (R, MPR) int32; lengths: (R,) int32, the
    query's position.  Contiguous CUDA tensors -> o: (R, H, hd).  Any
    group width G = H / K: a block holds up to 1024 / hd of a kv head's
    query rows, and a wider group is tiled over blocks.  One call is one
    counted launch (the split pass and its combine)."""
    dev = q.device
    tensors = (k_pages, v_pages, page_tables, lengths)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("paged_attention_rhd runs on one CUDA device")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    R, H, hd = q.shape
    _, ps, K, _ = k_pages.shape
    if k_pages.shape[3] != hd or H % K:
        raise ValueError(f"shapes: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}")
    if page_tables.shape[0] != R or page_tables.dim() != 2 \
            or lengths.shape != (R,):
        raise ValueError(f"page_tables {tuple(page_tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match R={R}")
    if page_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_tables and lengths must be int32")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    G = H // K
    if hd % 8:
        raise ValueError(f"needs hd % 8 == 0, got hd={hd}")
    if not all(t.is_contiguous() for t in (q,) + tensors):
        raise ValueError("paged_attention_rhd needs contiguous inputs")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention_rhd reads the pages with 16-byte "
                         "loads: k_pages and v_pages must be 16-byte aligned")
    scale = scale if scale else hd ** -0.5
    MPR = page_tables.shape[1]
    C = split_positions(hd, q.dtype)
    # the splits' fp32 partials: acc (R, K, NS, G, hd), then m and l
    # (R, K, NS, G) each (the layout of csrc/paged_attention.cu)
    NS = -(-MPR * ps // C)
    partials = torch.empty(R * K * NS * G * (hd + 2), dtype=torch.float32,
                           device=dev)
    o = torch.empty_like(q)
    err = _entry()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                   page_tables.data_ptr(), lengths.data_ptr(), o.data_ptr(),
                   partials.data_ptr(), R, K, G, hd, ps, MPR, C,
                   float(scale), int(window or 0), float(softcap or 0.0),
                   build.dtype_code(q.dtype), build.stream_ptr(dev))
    build.check(err, "paged_attention_rhd")
    paged_attention_rhd.launches += 1
    return o


paged_attention_rhd.launches = 0
