"""Host wrappers of the CUDA selective scan (``csrc/selective_scan.cu``),
which replaces the TPU kernel
``repro/kernels/selective_scan/kernel.py:selective_scan_kernel``, and of
its backward (``csrc/selective_scan_bwd.cu``; the TPU kernel has none).

Two routes of each, chosen by ``tma_route`` (``bwd_tma_route``) before
launch: the kernel's ring takes its tiles as TMA boxes where every
operand allows them, and as 4-byte cp.async copies elsewhere.  Both run
the same arithmetic and give the same bits."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build.library()
    fn = lib.repro_selective_scan
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    max_state = lib.repro_selective_scan_max_state
    max_state.restype = ctypes.c_int
    return fn, max_state()


def tma_route(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
              cm: torch.Tensor) -> bool:
    """The dispatch rule: TMA takes a scan when Di is a multiple of 4 and
    x, dt, B and C start 16-byte aligned, with B's and C's batch and time
    strides multiples of 4 floats (a tensor map's strides are whole
    16-byte chunks; a stride of a length-1 axis is never used).  Decided
    from the operands alone, before launch."""
    B, S, Di = x.shape
    if Di % 4 or any(t.data_ptr() % 16 for t in (x, dt, bm, cm)):
        return False
    return all((B == 1 or t.stride(0) % 4 == 0)
               and (S <= 1 or t.stride(1) % 4 == 0) for t in (bm, cm))


def _check(x, dt, bm, cm, a, h0) -> None:
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
    max_state = _entry()[1]
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


def _launch(x, dt, bm, cm, a, h0, *, tma: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch on the given route (True: TMA) of checked operands;
    counts no launch.  The card tests force each route through it."""
    B, S, Di = x.shape
    N = a.shape[-1]
    y = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    err = _entry()[0](
        x.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
        a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), B, S,
        Di, N, bm.stride(0), bm.stride(1), cm.stride(0), cm.stride(1),
        int(tma), build.stream_ptr(x.device))
    build.check(err, "selective_scan")
    return y, h_last


def selective_scan_kernel(x: torch.Tensor, dt: torch.Tensor,
                          bm: torch.Tensor, cm: torch.Tensor,
                          a: torch.Tensor, h0: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 CUDA tensors: x, dt (B, S, Di) contiguous; bm, cm (B, S, N)
    with unit stride along N (column slices of a wider tensor are read in
    place through their strides); a (Di, N) and h0 (B, Di, N) contiguous.
    Returns (y (B, S, Di), h_last (B, Di, N)).  ``launches`` counts the
    calls, ``tma_launches`` those that took the TMA route."""
    _check(x, dt, bm, cm, a, h0)
    tma = tma_route(x, dt, bm, cm)
    out = _launch(x, dt, bm, cm, a, h0, tma=tma)
    selective_scan_kernel.launches += 1
    selective_scan_kernel.tma_launches += int(tma)
    return out


selective_scan_kernel.launches = 0
selective_scan_kernel.tma_launches = 0


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    lib = build.library()
    fn = lib.repro_selective_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    scratch = lib.repro_selective_scan_bwd_scratch
    scratch.argtypes = [ctypes.c_int] * 4
    scratch.restype = ctypes.c_longlong
    return fn, scratch


def bwd_tma_route(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                  cm: torch.Tensor, dy: torch.Tensor) -> bool:
    """The backward's dispatch rule: the forward's (``tma_route``), and
    ``dy`` 16-byte aligned."""
    return tma_route(x, dt, bm, cm) and dy.data_ptr() % 16 == 0


def _bwd_check(x, dt, bm, cm, a, h0, dy, dh_last) -> None:
    _check(x, dt, bm, cm, a, h0)
    if dy.shape != x.shape or dy.dtype != torch.float32 \
            or dy.device != x.device or not dy.is_contiguous():
        raise ValueError(f"dy must be float32 contiguous {tuple(x.shape)} "
                         f"on {x.device}")
    if dh_last is not None and (
            dh_last.shape != h0.shape or dh_last.dtype != torch.float32
            or dh_last.device != x.device or not dh_last.is_contiguous()):
        raise ValueError(f"dh_last must be float32 contiguous "
                         f"{tuple(h0.shape)} on {x.device}")


def scratch_bytes(B: int, S: int, Di: int, N: int) -> int:
    """Device scratch of one backward launch: the states saved every
    tile, the blocks' partial sums of dB and dC, the rows' dA."""
    return 4 * _bwd_entry()[1](B, S, Di, N)


def _bwd_launch(x, dt, bm, cm, a, h0, dy, dh_last=None, *, tma: bool
                ) -> Tuple[torch.Tensor, ...]:
    """One backward launch on the given route (True: TMA) of checked
    operands; counts no launch.  The card tests force each route
    through it."""
    B, S, Di = x.shape
    N = a.shape[-1]
    fn, scratch_floats = _bwd_entry()
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dbm = torch.empty((B, S, N), dtype=torch.float32, device=x.device)
    dcm = torch.empty_like(dbm)
    da = torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    scratch = torch.empty(scratch_floats(B, S, Di, N), dtype=torch.float32,
                          device=x.device)
    err = fn(x.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
             a.data_ptr(), h0.data_ptr(), dy.data_ptr(),
             None if dh_last is None else dh_last.data_ptr(),
             dx.data_ptr(), ddt.data_ptr(), dbm.data_ptr(), dcm.data_ptr(),
             da.data_ptr(), dh0.data_ptr(), scratch.data_ptr(), B, S, Di, N,
             bm.stride(0), bm.stride(1), cm.stride(0), cm.stride(1),
             int(tma), build.stream_ptr(x.device))
    build.check(err, "selective_scan_bwd")
    return dx, ddt, dbm, dcm, da, dh0


def selective_scan_bwd_kernel(x: torch.Tensor, dt: torch.Tensor,
                              bm: torch.Tensor, cm: torch.Tensor,
                              a: torch.Tensor, h0: torch.Tensor,
                              dy: torch.Tensor,
                              dh_last: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """The scan's backward on the card.  The forward's operands as
    ``selective_scan_kernel`` takes them, ``dy`` (B, S, Di) and
    ``dh_last`` (B, Di, N, or ``None`` for 0) float32 contiguous.
    Returns (dx, ddt, dB, dC, dA, dh0), float32 and contiguous, shaped as
    the inputs.  Deterministic: no atomics, every sum in a fixed order.
    ``launches`` counts the calls (each runs the scan kernel and the
    fixed-order reduce of its per-block sums), ``tma_launches`` those
    whose ring took the TMA route (``bwd_tma_route``)."""
    _bwd_check(x, dt, bm, cm, a, h0, dy, dh_last)
    tma = bwd_tma_route(x, dt, bm, cm, dy)
    out = _bwd_launch(x, dt, bm, cm, a, h0, dy, dh_last, tma=tma)
    selective_scan_bwd_kernel.launches += 1
    selective_scan_bwd_kernel.tma_launches += int(tma)
    return out


selective_scan_bwd_kernel.launches = 0
selective_scan_bwd_kernel.tma_launches = 0
