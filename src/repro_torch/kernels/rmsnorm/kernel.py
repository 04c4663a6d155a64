"""Host wrappers of the CUDA RMSNorm kernels (``csrc/rmsnorm.cu``): the
forward replaces the TPU kernel
``repro/kernels/rmsnorm/kernel.py:rms_norm_2d``; the backward is new (the
TPU kernel had none)."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().repro_rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    lib = build.library()
    fn = lib.repro_rmsnorm_bwd
    fn.argtypes = ([ctypes.c_void_p] * 7
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    parts = lib.repro_rmsnorm_bwd_parts
    parts.argtypes = [ctypes.c_int]
    parts.restype = ctypes.c_int
    return fn, parts


def _check(x: torch.Tensor, w: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{name} runs on one CUDA device, got x on "
                         f"{x.device}, w on {w.device}")
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"shapes: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"w dtype {w.dtype} != x dtype {x.dtype}: cast the "
                        "weights to the compute dtype")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name} needs contiguous x and w")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte aligned x and w")


def rms_norm_2d(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                rstd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (R, D) contiguous CUDA tensor; w: (D,) of x's dtype -> (R, D).
    ``rstd``: an optional (R,) float32 tensor that receives each row's
    ``rsqrt(mean(x^2) + eps)`` for the backward (the training path)."""
    _check(x, w, "rms_norm_2d")
    R, D = x.shape
    if rstd is not None and (rstd.shape != (R,) or rstd.dtype != torch.float32
                             or rstd.device != x.device):
        raise ValueError("rstd must be a float32 (R,) tensor on x's device")
    y = torch.empty_like(x)
    err = _entry()(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                   rstd.data_ptr() if rstd is not None else None, R, D, eps,
                   build.dtype_code(x.dtype), build.stream_ptr(x.device))
    build.check(err, "rms_norm_2d")
    rms_norm_2d.launches += 1
    return y


rms_norm_2d.launches = 0


def rms_norm_2d_bwd(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                    rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients (dx (R, D), dw (D,)) of ``rms_norm_2d`` for the output
    gradient ``g`` (R, D); all of x's dtype.  ``rstd`` is the (R,)
    float32 row scale the forward saved."""
    _check(x, w, "rms_norm_2d_bwd")
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match x")
    if not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("rms_norm_2d_bwd needs a contiguous, aligned g")
    R, D = x.shape
    if (rstd.shape != (R,) or rstd.dtype != torch.float32
            or rstd.device != x.device or not rstd.is_contiguous()):
        raise ValueError("rstd must be a contiguous float32 (R,) tensor on "
                         "x's device")
    fn, parts = _bwd_entry()
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    partial = torch.empty(max(parts(R), 1), D, dtype=torch.float32,
                          device=x.device)
    err = fn(g.data_ptr(), x.data_ptr(), w.data_ptr(), rstd.data_ptr(),
             dx.data_ptr(), dw.data_ptr(), partial.data_ptr(), R, D,
             build.dtype_code(x.dtype), build.stream_ptr(x.device))
    build.check(err, "rms_norm_2d_bwd")
    rms_norm_2d_bwd.launches += 1
    return dx, dw


rms_norm_2d_bwd.launches = 0
