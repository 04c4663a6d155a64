"""Public ABFT matmul: encode -> multiply -> verify -> correct (the
reference's ``kernels/abft_matmul/ops.py``).  A CPU tensor takes the
plain version of the multiply, a CUDA tensor the kernel; anything else
raises.  Encoding (the checksum row and column) and verification are
plain tensor ops on both, as the reference keeps them outside its kernel.

``abft_matmul(a, b)`` returns the data product C and a report of the
checksum verification.  A single corrupted output element at (i, j)
shifts row residual i and column residual j by the same amount: the
intersection locates it and C[i, j] -= d corrects it in place, with no
rollback.  Inconsistent or multiple residuals are flagged as detected but
uncorrectable.  Detection is thresholded by the rows' and columns' L1
mass (``rtol``): the checksums are summed in another order than the data.

The report stays on the device as tensors (no host sync a projection);
``detections(device)`` reads the running count of detected reports, a
test hook that changes nothing.

``abft_dot`` is the layer-facing twin of ``x @ w`` (any leading dims,
silent single-error correction, the result in x's dtype), differentiable
with both backward contractions through the same checksummed kernel."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.abft_matmul.kernel import abft_matmul_ext
from repro_torch.kernels.abft_matmul.ref import checksums, encode_ref

__all__ = ["abft_matmul", "abft_dot", "verify_and_correct", "detections"]

_detected: Dict[torch.device, torch.Tensor] = {}


def detections(device) -> int:
    """Reports with ``detected`` true on ``device`` since the last
    ``reset_detections`` (reads the device counter: a sync)."""
    t = _detected.get(torch.device(device))
    return 0 if t is None else int(t)


def reset_detections() -> None:
    _detected.clear()


def _count(detected: torch.Tensor) -> None:
    dev = detected.device
    prev = _detected.get(dev)
    inc = detected.to(torch.int64)
    _detected[dev] = inc if prev is None else prev + inc


def _extended(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu" and b.device.type == "cpu":
        a_ext, b_ext = encode_ref(a, b)
        return a_ext @ b_ext
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"abft_matmul runs on the CPU (plain version) or "
                         f"one CUDA device (kernel), got {a.device} and "
                         f"{b.device}")
    a_sum, b_sum = checksums(a, b)
    return abft_matmul_ext(a, a_sum, b, b_sum)


def verify_and_correct(c_full: torch.Tensor, *, rtol: float = 1e-4,
                       atol: float = 1e-5, correct: bool = True
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Verify an extended product; returns (c, report).

    report (0-d tensors on c's device):
      detected    any residual above tolerance
      corrected   error isolated to one element (data or checksum) and,
                  for a data element, fixed in the returned c
      row, col    flagged coordinates (argmax residual; 0 when clean)
      delta       the correction applied at (row, col)
      bad_rows/bad_cols  residual counts (>1 of either: uncorrectable)"""
    c = c_full[:-1, :-1]
    row_check = c_full[:-1, -1]          # row sums of C via the extension
    col_check = c_full[-1, :-1]          # column sums of C
    abs_c = c.abs()
    d_row = c.sum(dim=1) - row_check
    d_col = c.sum(dim=0) - col_check
    tol_row = atol + rtol * (abs_c.sum(dim=1) + row_check.abs())
    tol_col = atol + rtol * (abs_c.sum(dim=0) + col_check.abs())
    bad_row = d_row.abs() > tol_row
    bad_col = d_col.abs() > tol_col
    n_row = bad_row.sum()
    n_col = bad_col.sum()
    detected = (n_row + n_col) > 0
    i = torch.argmax(d_row.abs() * bad_row)
    j = torch.argmax(d_col.abs() * bad_col)
    # one data element hit: both residuals trip, with consistent magnitude
    single_data = ((n_row == 1) & (n_col == 1)
                   & ((d_row[i] - d_col[j]).abs() <= tol_row[i] + tol_col[j]))
    # one checksum element hit: only its own residual trips; data intact
    checksum_only = (((n_row == 1) & (n_col == 0))
                     | ((n_row == 0) & (n_col == 1)))
    corrected = detected & (single_data | checksum_only)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    delta = torch.where(single_data, d_row[i], zero) if correct else zero
    c = c.contiguous()
    c.index_put_((i, j), -delta, accumulate=True)
    report = {"detected": detected, "corrected": corrected,
              "row": i, "col": j, "delta": delta,
              "bad_rows": n_row, "bad_cols": n_col}
    return c, report


def abft_matmul(a: torch.Tensor, b: torch.Tensor, *, rtol: float = 1e-4,
                atol: float = 1e-5, correct: bool = True,
                inject: Optional[Tuple[int, int, float]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """a: (M, K), b: (K, N) -> (C (M, N) float32, report).

    ``inject=(i, j, delta)`` adds ``delta`` to extended-product element
    (i, j) after the multiply and before verification: the deterministic
    SDC hook of the tests (i == M or j == N hit the checksums)."""
    c_full = _extended(a, b)
    if inject is not None:
        ii, jj, d = inject
        c_full[ii, jj] += d
    c, report = verify_and_correct(c_full, rtol=rtol, atol=atol,
                                   correct=correct)
    _count(report["detected"])
    return c, report


class _AbftDot(torch.autograd.Function):
    """x2 @ w through the checksummed multiply, and both backward
    contractions through it too: a flipped gradient element is corrected
    before it reaches the update."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return abft_matmul(x2, w)[0]

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = abft_matmul(g, w.t())[0].to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = abft_matmul(x2.t(), g)[0].to(w.dtype)
        return dx, dw


def abft_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Drop-in checksummed ``x @ w``: x (..., K), w (K, N) -> (..., N) in
    x's dtype, computed in float32 (checksums in half precision would
    drown in rounding)."""
    shape = x.shape
    c = _AbftDot.apply(x.reshape(-1, shape[-1]), w)
    return c.reshape(shape[:-1] + (w.shape[-1],)).to(x.dtype)
