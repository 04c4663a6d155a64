"""Host wrappers of the CUDA flash-attention kernels: the forward
(``csrc/flash_attention.cu``) replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention_bhsd``; the
backward (``csrc/flash_attention_bwd.cu``) is new (the TPU kernel had
none).  Both take head_dim 16, 32, 64, 80, 128 and 256."""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 80, 128, 256)
BWD_HEAD_DIMS = HEAD_DIMS


def check_backward_head_dim(hd: int) -> None:
    """The backward kernel's head dims; any other raises (never a plain
    version in its place)."""
    if hd not in BWD_HEAD_DIMS:
        raise ValueError(f"the flash backward takes head_dim in "
                         f"{BWD_HEAD_DIMS}, got {hd}")


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = build.library().repro_flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, name):
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"{name} runs on one CUDA device")
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
        raise ValueError(f"{name} needs contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name} reads 16-byte vectors: q, k and v must "
                         "be 16-byte aligned")
    return B, S, Sk, H, K, hd


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, scale=None,
                         lse: bool = False):
    """q: (B, S, H, hd); k, v: (B, Sk, K, hd), contiguous CUDA tensors of
    one dtype, H % K == 0 -> o: (B, S, H, hd).  S and Sk may be ragged.
    With ``lse=True`` returns (o, lse), lse the (B, H, S) float32
    log-sum-exp of each row's scores (the backward's input)."""
    B, S, Sk, H, K, hd = _check(q, k, v, "flash_attention_bshd")
    scale = scale if scale else hd ** -0.5
    o = torch.empty_like(q)
    lse_t = (torch.empty(B, H, S, dtype=torch.float32, device=q.device)
             if lse else None)
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   lse_t.data_ptr() if lse else None,
                   B, S, Sk, H, K, hd, float(scale), int(bool(causal)),
                   int(window or 0), float(softcap or 0.0),
                   build.dtype_code(q.dtype), build.stream_ptr(q.device))
    build.check(err, "flash_attention_bshd")
    flash_attention_bshd.launches += 1
    return (o, lse_t) if lse else o


flash_attention_bshd.launches = 0


def flash_attention_bshd_bwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             softcap: float = 0.0, scale=None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Gradients (dq, dk, dv) of ``flash_attention_bshd`` for the output
    gradient ``do``; ``o`` and ``lse`` are the forward's outputs.
    Deterministic: no float atomics, fixed summation order."""
    B, S, Sk, H, K, hd = _check(q, k, v, "flash_attention_bshd_bwd")
    check_backward_head_dim(hd)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must "
                             "match q")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (lse.shape != (B, H, S) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous float32 (B, H, S) "
                         f"tensor, got {tuple(lse.shape)} {lse.dtype}")
    scale = scale if scale else hd ** -0.5
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    # scratch: D = rowsum(dO * O) and the base-2 LSE, (B, H, S) rounded up
    # to 128 rows each (the bf16 kernels' tiles read them padded)
    sp = -(-S // 128) * 128
    dvec = torch.empty(2 * B * H * sp, dtype=torch.float32, device=q.device)
    err = _bwd_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, S, Sk, H, K, hd, float(scale),
        int(bool(causal)), int(window or 0), float(softcap or 0.0),
        build.dtype_code(q.dtype), build.stream_ptr(q.device))
    build.check(err, "flash_attention_bshd_bwd")
    flash_attention_bshd_bwd.launches += 1
    return dq, dk, dv


flash_attention_bshd_bwd.launches = 0
