"""The arithmetic of the ABFT matmul's tensor-core route, on the CPU.

The kernel (``csrc/abft_matmul.cu``) runs only on the card; its
arithmetic is kept here in plain PyTorch (``kernels/abft_matmul/ref.py``):
``split_bf16x3``, the exact split of a float32 value into three bfloat16
pieces, and ``abft_matmul_split_ref``, the extended product as the kernel
forms it (planes, three checksum rows and columns, the epilogue's fixed
fold).  The split is held bit for bit (in float64) over the float32
exponent range, with its edges stated; the model within 32 float32 ulps
of each element's absolute mass (``ABFT_TOL``, the card's bound) of the
port's plain version and of the JAX package's ``matmul_f32`` (its Pallas
kernel in interpret mode).  The wrapper's dispatch rule (``tc_route``)
is checked on CPU tensors: it reads only dtypes, shapes, strides and
alignment.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.abft_matmul.kernel import matmul_f32
from repro.kernels.abft_matmul.ref import encode_ref as jax_encode_ref
from repro_torch.kernels.abft_matmul.kernel import tc_route
from repro_torch.kernels.abft_matmul.ref import (abft_matmul_ref,
                                                 abft_matmul_split_ref,
                                                 product_mass, split_bf16x3)

ABFT_TOL = 32 * 2.0 ** -24
F32, BF16 = torch.float32, torch.bfloat16
# from here up hi = bf16(x) rounds to inf
TOP = 2.0 ** 128 * (1 - 2.0 ** -9)


def _sum64(x):
    return sum(p.to(torch.float64) for p in split_bf16x3(x))


@pytest.mark.parametrize("lo,hi", [(-110, -103), (-103, -40), (-40, 0),
                                   (0, 40), (40, 127)])
def test_split_is_exact_over_the_exponent_range(lo, hi):
    """hi + mid + lo == x for 2^lo <= |x| < 2^hi; below 2^-103 lo is a
    bf16 subnormal, which PyTorch keeps on the CPU."""
    rng = np.random.default_rng(hi - lo)
    n = 20000
    mant = rng.uniform(1.0, 2.0, n)
    exp = rng.integers(lo, hi, n).astype(np.float64)
    sign = rng.choice([-1.0, 1.0], n)
    x = torch.from_numpy((sign * mant * 2.0 ** exp).astype(np.float32))
    pieces = split_bf16x3(x)
    assert all(p.dtype == BF16 for p in pieces)
    assert torch.equal(_sum64(x), x.to(torch.float64))


def test_split_edges():
    # ±0: hi keeps the sign, mid and lo are +0
    hi, mid, lo = split_bf16x3(torch.tensor([0.0, -0.0]))
    assert torch.equal(torch.signbit(hi), torch.tensor([False, True]))
    assert not torch.signbit(mid).any() and not torch.signbit(lo).any()
    assert (hi == 0).all() and (mid == 0).all() and (lo == 0).all()
    # the underflow edge: exact at 2^-110 (lo down to bf16's smallest
    # subnormal, 2^-133), not below it
    at, below = (torch.tensor([(1 + 2.0 ** -23) * 2.0 ** e], dtype=F32)
                 for e in (-110, -111))
    assert torch.equal(_sum64(at), at.to(torch.float64))
    assert not torch.equal(_sum64(below), below.to(torch.float64))
    # the overflow edge: exact just below TOP, hi infinite at TOP
    top = torch.tensor([TOP], dtype=F32)
    under = torch.nextafter(top, torch.zeros(1))
    assert torch.equal(_sum64(under), under.to(torch.float64))
    assert torch.isinf(split_bf16x3(top)[0]).all()


def _jax_extended(a, b):
    """The JAX package's extended product: its encode, padded to its
    tiles, through matmul_f32 in interpret mode."""
    M, K = a.shape
    N = b.shape[1]
    a_ext, b_ext = jax_encode_ref(jnp.asarray(a), jnp.asarray(b))
    up = lambda n: -(-n // 128) * 128 if n > 128 else n   # noqa: E731
    mp, np_, kp = up(M + 1), up(N + 1), up(K)
    a_p = jnp.pad(a_ext, ((0, mp - M - 1), (0, kp - K)))
    b_p = jnp.pad(b_ext, ((0, kp - K), (0, np_ - N - 1)))
    return np.array(matmul_f32(a_p, b_p, interpret=True)[:M + 1, :N + 1])


@pytest.mark.parametrize("M,K,N", [(5, 7, 3), (13, 40, 9), (33, 130, 17)])
@pytest.mark.parametrize("a_dtype,b_dtype", [(BF16, BF16), (F32, BF16),
                                             (BF16, F32)])
def test_split_model_matches_plain_and_reference(M, K, N, a_dtype,
                                                 b_dtype):
    rng = np.random.default_rng(M * K + N)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(a_dtype)
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)
                         ).to(b_dtype)
    got = abft_matmul_split_ref(a, b)
    mass = product_mass(a, b)
    assert got.shape == (M + 1, N + 1) and got.dtype == F32
    assert ((got - abft_matmul_ref(a, b)).abs() / mass).max() <= ABFT_TOL
    want = torch.from_numpy(_jax_extended(a.float().numpy(),
                                          b.float().numpy()))
    assert ((got - want).abs() / mass).max() <= ABFT_TOL


def test_split_model_refuses_float32_x_float32():
    with pytest.raises(ValueError):
        abft_matmul_split_ref(torch.ones(2, 3), torch.ones(3, 4))


def _strided(rows, cols, ld, dtype, offset=0):
    """(rows, cols) row-major with leading dimension ld, starting
    `offset` elements into its storage."""
    base = torch.zeros(rows * ld + offset, dtype=dtype)
    return base[offset:].as_strided((rows, cols), (ld, 1))


@pytest.mark.parametrize("case,want", [
    ("bf16 x bf16, leading dims of 8k", True),
    ("f32 x bf16 (dx: g @ w^T, w^T column-major)", True),
    ("bf16 x f32 (dw: x^T @ g, x^T column-major)", True),
    ("f32 x f32", False),
    ("bf16 leading dim 7", False),
    ("bf16 column-major, leading dim 130", False),
    ("bf16 base 2 bytes off 16", False),
    ("a zero dimension", False)])
def test_tc_route_rule(case, want):
    x = _strided(64, 32, 32, BF16)
    w = _strided(32, 96, 96, BF16)
    g = torch.zeros(64, 96)
    operands = {
        "bf16 x bf16, leading dims of 8k": (x, w),
        "f32 x bf16 (dx: g @ w^T, w^T column-major)": (g, w.t()),
        "bf16 x f32 (dw: x^T @ g, x^T column-major)": (x.t(), g),
        "f32 x f32": (g.t(), g),
        "bf16 leading dim 7": (_strided(5, 7, 7, BF16),
                               _strided(7, 8, 8, BF16)),
        "bf16 column-major, leading dim 130": (
            _strided(16, 130, 130, BF16).t(), _strided(16, 8, 8, BF16)),
        "bf16 base 2 bytes off 16": (_strided(8, 16, 16, BF16, offset=1),
                                     _strided(16, 8, 8, BF16)),
        "a zero dimension": (torch.zeros(0, 16, dtype=BF16),
                             _strided(16, 8, 8, BF16)),
    }
    a, b = operands[case]
    assert tc_route(a, b) is want
