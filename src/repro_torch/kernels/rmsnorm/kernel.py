"""Host wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``), which
replaces the TPU kernel ``repro/kernels/rmsnorm/kernel.py:rms_norm_2d``."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().repro_rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rms_norm_2d(x: torch.Tensor, w: torch.Tensor, *,
                eps: float = 1e-6) -> torch.Tensor:
    """x: (R, D) contiguous CUDA tensor; w: (D,) of x's dtype -> (R, D)."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rms_norm_2d runs on one CUDA device, got x on "
                         f"{x.device}, w on {w.device}")
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"shapes: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"w dtype {w.dtype} != x dtype {x.dtype}: cast the "
                        "weights to the compute dtype at load")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rms_norm_2d needs contiguous x and w")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("rms_norm_2d needs 16-byte aligned x and w")
    R, D = x.shape
    y = torch.empty_like(x)
    err = _entry()(x.data_ptr(), w.data_ptr(), y.data_ptr(), R, D, eps,
                   build.dtype_code(x.dtype), build.stream_ptr(x.device))
    build.check(err, "rms_norm_2d")
    rms_norm_2d.launches += 1
    return y


rms_norm_2d.launches = 0
