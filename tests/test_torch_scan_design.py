"""The arithmetic of the port's selective-scan kernel, on the CPU.

``csrc/selective_scan.cu`` runs only on the card.  It takes the decay as
exp2(dt * fl32(A log2 e)), splits a channel's states into 8 parts (one
warp each, 2 states at N 16), sums each part's C h in increasing n and
folds the parts' sums in a fixed tree.  ``kernels/selective_scan/ref.py``
models that order (``selective_scan_parts_ref``); here the model is held to the
JAX ``selective_scan`` (its Pallas kernel in interpret mode) and its
sequential ``selective_scan_ref`` within 1e-5 + 1e-5 |want| (the
tolerance of tests/test_kernels.py), at the draws of the existing scan
tests, at falcon-mamba-7b's own A and dt (``A_log`` = log 1..16, ``dt_b``
-4.6), and over a wide range (dt up to 1, |dt A| up to 16).  Inputs come
from numpy seeds.  The wrapper's route rule (``tma_route``) is checked
on CPU tensors: it reads only shapes, strides and alignment.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.ops import selective_scan as jax_scan
from repro.kernels.selective_scan.ref import \
    selective_scan_ref as jax_scan_ref
from repro_torch.kernels.selective_scan.kernel import tma_route
from repro_torch.kernels.selective_scan.ref import (PARTS, part_tree_ref,
                                                    selective_scan_parts_ref,
                                                    selective_scan_ref,
                                                    states_per_part)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draws(rng, B, S, Di, N, h0_zero=False):
    """tests/test_kernels.py's draws: x, B, C ~ N(0, 1), dt =
    softplus(N(0, 1)) / 10, A = -exp(N(0, 1) / 5), h0 ~ N(0, 1) / 10."""
    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x, bm, cm = randn(B, S, Di), randn(B, S, N), randn(B, S, N)
    dt = (np.logaddexp(randn(B, S, Di), 0.0) * 0.1).astype(np.float32)
    a = -np.exp(randn(Di, N) * 0.2).astype(np.float32)
    h0 = (np.zeros((B, Di, N), np.float32) if h0_zero
          else randn(B, Di, N) * 0.1)
    return x, dt, bm, cm, a, h0


def _falcon_mamba(rng, B, S, Di, N):
    """falcon-mamba-7b's A (``A_log`` = log 1..N a channel, so A = -1..-N)
    and dt (softplus of a projection around ``dt_b`` = -4.6)."""
    x, _, bm, cm, _, h0 = _draws(rng, B, S, Di, N)
    dt = np.logaddexp(rng.standard_normal((B, S, Di)) - 4.6, 0.0)
    a = -np.exp(np.log(np.arange(1, N + 1, dtype=np.float32)))
    a = np.broadcast_to(a, (Di, N))
    return (x, dt.astype(np.float32), bm, cm,
            np.ascontiguousarray(a, np.float32), h0)


def _wide(rng, B, S, Di, N):
    """dt uniform up to 1 and A down to -16: |dt A| up to 16."""
    x, _, bm, cm, _, h0 = _draws(rng, B, S, Di, N)
    dt = rng.uniform(0.0, 1.0, (B, S, Di)).astype(np.float32)
    a = -rng.uniform(0.0, 16.0, (Di, N)).astype(np.float32)
    return x, dt, bm, cm, a, h0


def _hold_to_jax(args, parts):
    y, h = selective_scan_parts_ref(*(torch.from_numpy(t) for t in args),
                                    parts=parts)
    assert y.dtype == h.dtype == torch.float32
    jargs = [jnp.asarray(t) for t in args]
    for want_y, want_h in (jax_scan(*jargs, interpret=True),
                           jax_scan_ref(*jargs)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=TOL,
                                   rtol=TOL)


# the draws of tests/test_kernels.py and tests/test_torch_kernels_ref.py
@pytest.mark.parametrize("B,S,Di,N,h0_zero", [
    (1, 64, 32, 4, True), (2, 128, 64, 8, False), (1, 256, 128, 16, False),
    (2, 100, 64, 8, False), (1, 37, 128, 16, False), (2, 1, 16, 16, False),
    (3, 65, 33, 5, False)])
@pytest.mark.parametrize("parts", [PARTS, 4])
def test_part_model_matches_jax_at_the_existing_draws(B, S, Di, N, h0_zero,
                                                      parts):
    rng = np.random.default_rng(S + N)
    _hold_to_jax(_draws(rng, B, S, Di, N, h0_zero), parts)


@pytest.mark.parametrize("B,S,Di,N", [(1, 200, 64, 16), (2, 57, 32, 16)])
def test_part_model_matches_jax_at_falcon_mamba_a_and_dt(B, S, Di, N):
    rng = np.random.default_rng(Di + S)
    _hold_to_jax(_falcon_mamba(rng, B, S, Di, N), PARTS)


@pytest.mark.parametrize("B,S,Di,N", [(1, 128, 64, 16), (2, 33, 32, 15),
                                      (1, 50, 16, 3)])
def test_part_model_matches_jax_over_a_wide_range(B, S, Di, N):
    rng = np.random.default_rng(7 * S + N)
    args = _wide(rng, B, S, Di, N)
    assert np.abs(args[1][..., None] * args[4][None, None]).max() > 12.0
    _hold_to_jax(args, PARTS)


def test_part_tree_order():
    """Parts 0-3 take parts 4-7, then 0-1 take 2-3, then 0 takes 1."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.standard_normal((1000, 8)).astype(np.float32)
                         * 10.0 ** rng.integers(-6, 6, (1000, 8)))
    want = (((p[:, 0] + p[:, 4]) + (p[:, 2] + p[:, 6]))
            + ((p[:, 1] + p[:, 5]) + (p[:, 3] + p[:, 7])))
    assert torch.equal(part_tree_ref(p), want)
    four = p[:, :4]
    assert torch.equal(part_tree_ref(four),
                       (four[:, 0] + four[:, 2]) + (four[:, 1] + four[:, 3]))


@pytest.mark.parametrize("parts,want", [
    (8, {1: 1, 8: 1, 9: 2, 16: 2}), (4, {1: 1, 4: 1, 5: 2, 8: 2, 9: 4,
                                         12: 4, 16: 4}),
    (2, {1: 1, 2: 1, 3: 2, 5: 4, 9: 8, 16: 8})])
def test_states_per_part(parts, want):
    assert {n: states_per_part(n, parts) for n in want} == want


def test_part_model_split_scan_is_one_scan():
    """The model's arithmetic of a step does not depend on where a scan
    starts: S1 steps, then S2 from h_last, give the bits of one scan."""
    rng = np.random.default_rng(11)
    x, dt, bm, cm, a, h0 = (torch.from_numpy(t) for t in
                            _draws(rng, 2, 70, 24, 16))
    y, h = selective_scan_parts_ref(x, dt, bm, cm, a, h0)
    y1, h1 = selective_scan_parts_ref(x[:, :33], dt[:, :33], bm[:, :33],
                                      cm[:, :33], a, h0)
    y2, h2 = selective_scan_parts_ref(x[:, 33:], dt[:, 33:], bm[:, 33:],
                                      cm[:, 33:], a, h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(h2, h)


def test_part_model_close_to_the_plain_version():
    """The model and the plain version the CPU path runs differ only in
    the decay's base and the order of the y sum."""
    rng = np.random.default_rng(12)
    args = [torch.from_numpy(t) for t in _draws(rng, 1, 90, 40, 16)]
    for got, want in zip(selective_scan_parts_ref(*args),
                         selective_scan_ref(*args)):
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def _bc(B, S, width, start, N, dtype=torch.float32):
    """B as a column slice of a (B, S, width) tensor, starting at
    ``start`` (the x_proj output the Mamba layer slices)."""
    base = torch.zeros(B, S, width, dtype=dtype)
    return base[..., start:start + N]


def test_tma_route_rule():
    x = torch.zeros(2, 16, 64)
    dt = torch.zeros_like(x)
    bm, cm = _bc(2, 16, 32, 0, 16), _bc(2, 16, 32, 16, 16)
    assert tma_route(x, dt, bm, cm)
    # bf16 falcon-mamba: bcd[..., dtr:].float() is a contiguous (B, S, 2N)
    assert tma_route(x, dt, _bc(2, 16, 40, 8, 16), _bc(2, 16, 40, 24, 16))
    # Di not a multiple of 4
    x33 = torch.zeros(2, 16, 33)
    assert not tma_route(x33, torch.zeros_like(x33), bm, cm)
    # B or C not 16-byte aligned, or a time stride of 4 k + 2 floats
    assert not tma_route(x, dt, _bc(2, 16, 32, 2, 16), cm)
    assert not tma_route(x, dt, bm, _bc(2, 16, 34, 16, 16))
    # x at an offset of 8 bytes
    flat = torch.zeros(2 * 16 * 64 + 2)
    assert not tma_route(flat[2:].view(2, 16, 64), dt, bm, cm)
    # a length-1 axis's stride is never read
    one = torch.zeros(1, 1, 64)
    assert tma_route(one, torch.zeros_like(one), _bc(1, 1, 18, 0, 16),
                      _bc(1, 1, 18, 0, 16))
