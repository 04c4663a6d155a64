"""Host wrapper of the CUDA ABFT matmul (``csrc/abft_matmul.cu``), which
replaces the TPU kernel ``repro/kernels/abft_matmul/kernel.py:
matmul_f32``.

Two routes, chosen by ``tc_route`` before launch: the tensor cores (exact
bf16 pieces on ``wgmma``) where at least one operand is bfloat16 and TMA
can read every bfloat16 operand in place, else the CUDA-core SGEMM."""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _entries():
    lib = build.library()
    fn = lib.repro_abft_matmul
    fn.argtypes = ([ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    scratch = lib.repro_abft_scratch_bytes
    scratch.argtypes = [ctypes.c_int] * 5
    scratch.restype = ctypes.c_longlong
    return fn, scratch


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


def tc_route(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The dispatch rule: the tensor-core route takes a product when at
    least one operand is bfloat16 (a float32 operand is split into three
    bf16 planes; float32 x float32 would need nine), no dimension is 0,
    and TMA can read each bfloat16 operand in place: a 16-byte aligned
    base and a leading dimension of a multiple of 8 elements.  Everything
    else takes the CUDA-core SGEMM.  Decided from the operands alone,
    before launch."""
    if torch.bfloat16 not in (a.dtype, b.dtype) or 0 in (*a.shape,
                                                          b.shape[1]):
        return False
    for x, name in ((a, "a"), (b, "b")):
        if x.dtype == torch.bfloat16 and (x.data_ptr() % 16
                                          or _layout(x, name)[1] % 8):
            return False
    return True


def _launch(a, a_sum, b, b_sum, *, route: bool) -> torch.Tensor:
    """One launch on the given route (True: the tensor cores); counts no
    launch.  The card tests force each route through it."""
    M, K = a.shape
    N = b.shape[1]
    a_row, lda = _layout(a, "a")
    b_row, ldb = _layout(b, "b")
    a_dt, b_dt = build.dtype_code(a.dtype), build.dtype_code(b.dtype)
    fn, scratch_bytes = _entries()
    dev = a.device
    c = torch.empty(M + 1, N + 1, dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_bytes(M, N, K, a_dt, b_dt) if route else 0,
                          dtype=torch.uint8, device=dev)
    err = fn(a.data_ptr(), a_sum.data_ptr(), b.data_ptr(), b_sum.data_ptr(),
             c.data_ptr(), scratch.data_ptr(), M, N, K, lda, ldb, a_dt,
             a_row, b_dt, b_row, int(route), build.stream_ptr(dev))
    build.check(err, "abft_matmul_ext")
    return c


def abft_matmul_ext(a: torch.Tensor, a_sum: torch.Tensor, b: torch.Tensor,
                    b_sum: torch.Tensor) -> torch.Tensor:
    """C_full = [A; a_sum] @ [B, b_sum] in float32 on one CUDA device.

    a: (M, K), b: (K, N), float32 or bfloat16, each row- or column-major
    (read in place); a_sum, b_sum: (K,) float32 contiguous.  Returns the
    (M + 1, N + 1) float32 product, row-major.  ``launches`` counts the
    calls, ``tc_launches`` those that took the tensor-core route."""
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
    if max(M, N, K) >= 2 ** 31 - 64:
        raise ValueError(f"abft_matmul_ext: dimensions {M, N, K} too large")
    route = tc_route(a, b)
    c = _launch(a, a_sum, b, b_sum, route=route)
    abft_matmul_ext.launches += 1
    abft_matmul_ext.tc_launches += int(route)
    return c


abft_matmul_ext.launches = 0
abft_matmul_ext.tc_launches = 0
