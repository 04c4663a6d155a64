"""Host wrapper of the CUDA ABFT matmul (``csrc/abft_matmul.cu``), which
replaces the TPU kernel ``repro/kernels/abft_matmul/kernel.py:
matmul_f32``."""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library().repro_abft_matmul
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _layout(x: torch.Tensor, name: str) -> Tuple[int, int]:
    """(row_major, leading dimension) of a 2-D operand read in place:
    row-major when its last axis is contiguous, column-major when its
    first is (a transposed view); anything else raises."""
    r, c = x.shape
    s0, s1 = x.stride()
    if s1 == 1 and (s0 >= max(c, 1) or r <= 1):
        return 1, max(s0, c, 1)
    if s0 == 1 and (s1 >= max(r, 1) or c <= 1):
        return 0, max(s1, r, 1)
    raise ValueError(f"{name} {tuple(x.shape)} with strides {x.stride()} "
                     "is neither row- nor column-major")


def abft_matmul_ext(a: torch.Tensor, a_sum: torch.Tensor, b: torch.Tensor,
                    b_sum: torch.Tensor) -> torch.Tensor:
    """C_full = [A; a_sum] @ [B, b_sum] in float32 on one CUDA device.

    a: (M, K), b: (K, N), float32 or bfloat16, each row- or column-major
    (read in place); a_sum, b_sum: (K,) float32 contiguous.  Returns the
    (M + 1, N + 1) float32 product, row-major."""
    dev = a.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (a_sum, b, b_sum)):
        raise ValueError("abft_matmul_ext runs on one CUDA device")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes: a {tuple(a.shape)}, b {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    for name, s in (("a_sum", a_sum), ("b_sum", b_sum)):
        if (s.shape != (K,) or s.dtype != torch.float32
                or not s.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({K},) float32 "
                             f"tensor, got {tuple(s.shape)} {s.dtype}")
    if max(M, N, K) >= 2 ** 31 - 1:
        raise ValueError(f"abft_matmul_ext: dimensions {M, N, K} too large")
    a_row, lda = _layout(a, "a")
    b_row, ldb = _layout(b, "b")
    c = torch.empty(M + 1, N + 1, dtype=torch.float32, device=dev)
    err = _entry()(a.data_ptr(), a_sum.data_ptr(), b.data_ptr(),
                   b_sum.data_ptr(), c.data_ptr(), M, N, K, lda, ldb,
                   build.dtype_code(a.dtype), a_row,
                   build.dtype_code(b.dtype), b_row,
                   build.stream_ptr(dev))
    build.check(err, "abft_matmul_ext")
    abft_matmul_ext.launches += 1
    return c


abft_matmul_ext.launches = 0
