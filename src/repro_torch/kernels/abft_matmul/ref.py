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
