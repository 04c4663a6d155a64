"""Plain PyTorch version of the ABFT checksum-extended matmul (the
reference's ``kernels/abft_matmul/ref.py``).

Huang & Abraham's algorithm-based fault tolerance: extend A with a
column-checksum row (the sum of A's rows) and B with a row-checksum
column (the sum of B's columns); one multiply of the extended operands
yields C and its own row/column checksums, computed through the same
arithmetic as the data.  A single corrupted output element perturbs
exactly one row check and one column check: their intersection locates
it, their magnitude corrects it."""
from __future__ import annotations

from typing import Tuple

import torch


def checksums(a: torch.Tensor, b: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K), (K, N) -> (a_sum (K,), b_sum (K,)) in float32: row M of
    A_ext and column N of B_ext."""
    return (torch.sum(a, dim=0, dtype=torch.float32),
            torch.sum(b, dim=1, dtype=torch.float32))


def encode_ref(a: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K), (K, N) -> checksum-extended (M+1, K), (K, N+1) float32."""
    a_sum, b_sum = checksums(a, b)
    a_ext = torch.cat([a.to(torch.float32), a_sum[None, :]], dim=0)
    b_ext = torch.cat([b.to(torch.float32), b_sum[:, None]], dim=1)
    return a_ext, b_ext


def abft_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Extended product C_full (M+1, N+1) float32: data block
    C_full[:-1, :-1], column-checksum row C_full[-1, :-1], row-checksum
    column C_full[:-1, -1]."""
    a_ext, b_ext = encode_ref(a, b)
    return a_ext @ b_ext


def product_mass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|A_ext| @ |B_ext| (M+1, N+1) float32: each extended-product
    element's absolute mass.  A float32 sum's rounding error scales with
    it, not with the element (which cancellation can make small), so a
    check of the product is held to a multiple of it."""
    a_ext, b_ext = encode_ref(a, b)
    return a_ext.abs() @ b_ext.abs()


def residuals_ref(c_full: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row/column checksum residuals of an extended product:
    d_row[i] = sum_j C[i,j] - rowcheck[i], d_col[j] = sum_i C[i,j] -
    colcheck[j]."""
    c = c_full[:-1, :-1]
    return (c.sum(dim=1) - c_full[:-1, -1], c.sum(dim=0) - c_full[-1, :-1])


def split_bf16x3(x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tensor-core route's exact split of a float32 tensor into three
    bfloat16 pieces, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
    mid), as ``csrc/abft_matmul.cu`` (split3) computes them.  hi + mid +
    lo == x exactly for 2^-103 <= |x| < 2^128 (1 - 2^-9) (every piece a
    normal bf16; from 2^128 (1 - 2^-9) = 3.3961e38 up hi rounds to inf).
    Between 2^-110 and 2^-103 lo is a bf16 subnormal, exact where
    subnormals are kept (PyTorch on the CPU keeps them); below 2^-110 lo
    loses bits.  ±0 splits into hi = ±0, mid = lo = +0."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    r = x - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def _fold(parts):
    """(p0 + p1) + p2, or p0 alone: the epilogue's fixed order."""
    return parts[0] if len(parts) == 1 else (parts[0] + parts[1]) + parts[2]


def abft_matmul_split_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A plain model of the tensor-core route's arithmetic (no path runs
    it): the extended product (M + 1, N + 1) as the kernel forms it.

    A float32 operand becomes its three bf16 planes along K ([A_hi |
    A_mid | A_lo], or [B_hi; B_mid; B_lo]) with its checksum's planes as
    one more row (column), and its bf16 partner is repeated three times
    along K; a bf16 operand keeps its data and takes its float32
    checksum's three pieces as three rows (columns), repeated along the
    planes.  One float32 product of those bf16 values (every term exact),
    then the fold of the checksum rows into row M and of the columns into
    column N, (p0 + p1) + p2, the corner over rows of column folds.
    float32 x float32 is not the tensor-core route's and raises."""
    f32 = torch.float32
    if a.dtype == f32 and b.dtype == f32:
        raise ValueError("the tensor-core route takes a bfloat16 operand")
    a_sum, b_sum = checksums(a, b)
    planes = 3 if f32 in (a.dtype, b.dtype) else 1
    if a.dtype == f32:
        a_rows = torch.cat([torch.cat(split_bf16x3(a), dim=1),
                            torch.cat(split_bf16x3(a_sum), dim=0)[None]])
    else:
        a_rows = torch.cat([a.repeat(1, planes)]
                           + [p.repeat(planes)[None]
                              for p in split_bf16x3(a_sum)])
    if b.dtype == f32:
        b_cols = torch.cat([torch.cat(split_bf16x3(b), dim=0),
                            torch.cat(split_bf16x3(b_sum), dim=0)[:, None]],
                           dim=1)
    else:
        b_cols = torch.cat([b.repeat(planes, 1)]
                           + [p.repeat(planes)[:, None]
                              for p in split_bf16x3(b_sum)], dim=1)
    p = a_rows.to(f32) @ b_cols.to(f32)
    M, N = a.shape[0], b.shape[1]
    rows = [p[M + i] for i in range(p.shape[0] - M)]
    out = torch.empty(M + 1, N + 1, dtype=f32)
    out[:M, :N] = p[:M, :N]
    out[:M, N] = _fold([p[:M, N + j] for j in range(p.shape[1] - N)])
    out[M, :N] = _fold([r[:N] for r in rows])
    out[M, N] = _fold([_fold([r[N + j] for j in range(p.shape[1] - N)])
                       for r in rows])
    return out
