"""Host wrapper of the CUDA selective scan (``csrc/selective_scan.cu``),
which replaces the TPU kernel
``repro/kernels/selective_scan/kernel.py:selective_scan_kernel``."""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build.library()
    fn = lib.repro_selective_scan
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    max_state = lib.repro_selective_scan_max_state
    max_state.restype = ctypes.c_int
    return fn, max_state()


def selective_scan_kernel(x: torch.Tensor, dt: torch.Tensor,
                          bm: torch.Tensor, cm: torch.Tensor,
                          a: torch.Tensor, h0: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 CUDA tensors: x, dt (B, S, Di) contiguous; bm, cm (B, S, N)
    with unit stride along N (column slices of a wider tensor are read in
    place through their strides); a (Di, N) and h0 (B, Di, N) contiguous.
    Returns (y (B, S, Di), h_last (B, Di, N))."""
    ts = (x, dt, bm, cm, a, h0)
    if any(t.device.type != "cuda" or t.device != x.device for t in ts):
        raise ValueError("selective_scan runs on one CUDA device, got "
                         + ", ".join(str(t.device) for t in ts))
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("selective_scan takes float32 tensors")
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and dt {tuple(dt.shape)} "
                         "must be one (B, S, Di) shape")
    B, S, Di = x.shape
    N = a.shape[-1]
    if (a.shape != (Di, N) or h0.shape != (B, Di, N)
            or bm.shape != (B, S, N) or cm.shape != (B, S, N)):
        raise ValueError(f"shapes: x {tuple(x.shape)}, B {tuple(bm.shape)}, "
                         f"C {tuple(cm.shape)}, A {tuple(a.shape)}, "
                         f"h0 {tuple(h0.shape)}")
    fn, max_state = _entry()
    if N > max_state:
        raise ValueError(f"selective_scan supports ssm_state up to "
                         f"{max_state}, got {N}")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's 65535 rows")
    if not (x.is_contiguous() and dt.is_contiguous() and a.is_contiguous()
            and h0.is_contiguous()):
        raise ValueError("selective_scan needs contiguous x, dt, A and h0")
    if N > 1 and (bm.stride(2) != 1 or cm.stride(2) != 1):
        raise ValueError("selective_scan needs unit stride along N in B "
                         "and C")
    y = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    err = fn(x.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
             a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
             B, S, Di, N, bm.stride(0), bm.stride(1), cm.stride(0),
             cm.stride(1), build.stream_ptr(x.device))
    build.check(err, "selective_scan")
    selective_scan_kernel.launches += 1
    return y, h_last


selective_scan_kernel.launches = 0
