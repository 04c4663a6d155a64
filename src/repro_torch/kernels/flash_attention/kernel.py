"""Host wrapper of the CUDA flash-attention forward kernel
(``csrc/flash_attention.cu``), which replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention_bhsd``."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, scale=None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, Sk, K, hd), contiguous CUDA tensors of
    one dtype, H % K == 0 -> o: (B, S, H, hd).  S and Sk may be ragged."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention_bshd runs on one CUDA device")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    _, Sk, K, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or H % K:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_bshd needs contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_bshd reads 16-byte vectors: q, k "
                         "and v must be 16-byte aligned")
    scale = scale if scale else hd ** -0.5
    o = torch.empty_like(q)
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   B, S, Sk, H, K, hd, float(scale), int(bool(causal)),
                   int(window or 0), float(softcap or 0.0),
                   build.dtype_code(q.dtype), build.stream_ptr(dev))
    build.check(err, "flash_attention_bshd")
    flash_attention_bshd.launches += 1
    return o


flash_attention_bshd.launches = 0
