"""The port's plain kernel versions against the JAX package on the CPU.

Inputs are drawn with numpy from a fixed seed and handed to both
packages.  The JAX side runs the way tests/test_kernels.py runs it: the
Pallas kernel in interpret mode, and its jnp reference.  Tolerances are
those of tests/test_kernels.py: 2e-5 in float32, 2e-2 in bfloat16 (the
plain flash version scales q in the compute dtype where the Pallas kernel
scales in fp32; in bf16 the tolerance covers the difference).  The
gradients of the plain RMSNorm and attention (what the backward kernels
are held to on the card) match ``jax.grad`` of the reference's within
1e-4 of their largest magnitude in float32 (sums over many terms, taken
in another order).  The plain int8 codec gives the bytes of the
reference's jnp codec reference; the plain block hash's word view is the
reference's ``words_view``, and the plain ABFT encode, extended product
and residuals match the reference's jnp oracle within 2e-5.  The plain
selective scan matches the reference's Pallas scan (interpret mode) and
its sequential oracle within 1e-5 (tests/test_kernels.py's tolerance),
at ragged lengths, two rows and a nonzero initial state.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.abft_matmul.ref import abft_matmul_ref as jax_abft_ref
from repro.kernels.abft_matmul.ref import encode_ref as jax_encode_ref
from repro.kernels.abft_matmul.ref import residuals_ref as jax_residuals_ref
from repro.kernels.block_hash.ops import words_view as jax_words_view
from repro.kernels.ckpt_codec.ref import dequantize_ref as jax_dequantize_ref
from repro.kernels.ckpt_codec.ref import quantize_ref as jax_quantize_ref
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.paged_attention.ops import \
    paged_decode_attention as jax_paged
from repro.kernels.rmsnorm.ops import rms_norm as jax_rms_norm
from repro.kernels.rmsnorm.ref import rms_norm_ref as jax_rms_norm_ref
from repro.kernels.selective_scan.ops import selective_scan as jax_scan
from repro.kernels.selective_scan.ref import \
    selective_scan_ref as jax_scan_ref
from repro_torch.kernels.abft_matmul.ref import (abft_matmul_ref,
                                                 encode_ref, residuals_ref)
from repro_torch.kernels.block_hash.ref import words_per_element, words_view
from repro_torch.kernels.ckpt_codec.ref import dequantize_ref, quantize_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.rmsnorm.ops import rms_norm
from repro_torch.kernels.rmsnorm.ref import rms_norm_ref
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers beside
    timing-sensitive multi-process tests, and idle OpenMP threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU torch tensor."""
    jdt, tdt, _ = DTYPES[dtype]
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
        return (jnp.asarray(a),
                torch.from_numpy(a.astype(np.float32)).to(tdt))
    a = a.astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(t: torch.Tensor, j, tol: float) -> None:
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("shape", [(4, 64), (2, 16, 128), (128, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax(shape, dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal(shape), dtype)
    # the port casts weights to the compute dtype at load
    wj, wt = _pair(rng.standard_normal(shape[-1]), dtype)
    tol = DTYPES[dtype][2]
    yt = rms_norm(xt, wt)
    _close(yt, jax_rms_norm(xj, wj, interpret=True), tol)
    _close(yt, jax_rms_norm_ref(xj, wj), tol)


FLASH_SHAPES = [(1, 128, 4, 4, 32), (2, 256, 4, 2, 64), (1, 256, 8, 1, 64),
                (1, 512, 2, 2, 128)]
FLASH_MODES = [(True, 0, 0.0), (True, 64, 0.0), (True, 0, 30.0),
               (False, 0, 0.0)]


def _flash_inputs(B, S, H, K, hd, dtype, seed=1):
    rng = np.random.default_rng(seed)
    q = _pair(rng.standard_normal((B, S, H, hd)), dtype)
    k = _pair(rng.standard_normal((B, S, K, hd)), dtype)
    v = _pair(rng.standard_normal((B, S, K, hd)), dtype)
    return q, k, v


@pytest.mark.parametrize("B,S,H,K,hd", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window,softcap", FLASH_MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax(B, S, H, K, hd, causal, window, softcap,
                                 dtype):
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(B, S, H, K, hd, dtype)
    tol = DTYPES[dtype][2]
    ot = flash_attention(qt, kt, vt, causal=causal, window=window,
                         softcap=softcap)
    _close(ot, jax_flash(qj, kj, vj, causal=causal, window=window,
                         softcap=softcap, block_q=128, block_k=128,
                         interpret=True), tol)
    _close(ot, attention_ref(qj, kj, vj, causal=causal, window=window,
                             softcap=softcap), tol)


@pytest.mark.parametrize("S", [100, 300])
@pytest.mark.parametrize("causal,window,softcap", FLASH_MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_ragged_matches_jax_ref(S, causal, window, softcap,
                                            dtype):
    """Ragged prompt lengths reach prefill; the Pallas kernel asserts
    S % block == 0, so the oracle is the jnp reference."""
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(1, S, 4, 2, 32, dtype, 2)
    ot = flash_attention(qt, kt, vt, causal=causal, window=window,
                         softcap=softcap)
    _close(ot, attention_ref(qj, kj, vj, causal=causal, window=window,
                             softcap=softcap), DTYPES[dtype][2])


@pytest.mark.parametrize("S,H,K,hd", [(128, 4, 2, 256), (128, 4, 4, 80),
                                      (100, 2, 1, 256), (72, 2, 2, 80)])
@pytest.mark.parametrize("causal,window,softcap", FLASH_MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_wide_heads_match_jax(S, H, K, hd, causal, window,
                                          softcap, dtype):
    """head_dim 256 (gemma-7b, recurrentgemma-2b) and 80 (hubert-xlarge,
    non-causal), which the TPU kernel takes as any other: against the
    Pallas kernel in interpret mode where S is a whole block (ragged S
    against the jnp reference only, as above)."""
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(1, S, H, K, hd, dtype, 5)
    tol = DTYPES[dtype][2]
    kw = dict(causal=causal, window=window, softcap=softcap)
    ot = flash_attention(qt, kt, vt, **kw)
    if S % 128 == 0:
        _close(ot, jax_flash(qj, kj, vj, block_q=128, block_k=128,
                             interpret=True, **kw), tol)
    _close(ot, attention_ref(qj, kj, vj, **kw), tol)


def paged_case(R, H, K, hd, ps, mpr, dtype, num_pages, seed=3):
    """The grid of tests/test_kernels.py:_paged_case from numpy: each row
    maps ``mpr`` distinct live pages; lengths land in every page,
    including the last page's final slot and a single-position row."""
    rng = np.random.default_rng(seed)
    q = _pair(rng.standard_normal((R, 1, H, hd)), dtype)
    kp = _pair(rng.standard_normal((num_pages, ps, K, hd)), dtype)
    vp = _pair(rng.standard_normal((num_pages, ps, K, hd)), dtype)
    perm = rng.permutation(np.arange(1, num_pages))
    pt = perm[:R * mpr].reshape(R, mpr).astype(np.int32)
    ln = ((np.arange(R) * 7) % (mpr * ps)).astype(np.int32)
    ln[-1] = mpr * ps - 1
    ln[0] = 0
    return (q, kp, vp, (jnp.asarray(pt), torch.from_numpy(pt)),
            (jnp.asarray(ln), torch.from_numpy(ln)))


@pytest.mark.parametrize("R,H,K,hd,ps,mpr", [
    (4, 4, 4, 32, 16, 4), (3, 8, 2, 64, 16, 2), (5, 4, 1, 64, 8, 3)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (0, 30.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_jax(R, H, K, hd, ps, mpr, window, softcap,
                                 dtype):
    case = paged_case(R, H, K, hd, ps, mpr, dtype, R * mpr + 3)
    (qj, qt), (kj, kt), (vj, vt), (pj, ptt), (lj, lt) = case
    tol = DTYPES[dtype][2]
    ot = paged_decode_attention(qt, kt, vt, ptt, lt, window=window,
                                softcap=softcap)
    for impl in ("pallas", "ref"):
        kw = {"interpret": True} if impl == "pallas" else {}
        oj = jax_paged(qj, kj, vj, pj, lj, window=window, softcap=softcap,
                       impl=impl, **kw)
        _close(ot, oj, tol)


@pytest.mark.parametrize("R,H,K,hd,ps,mpr", [
    (3, 16, 1, 256, 16, 2), (3, 10, 1, 256, 8, 3), (2, 32, 2, 128, 16, 2)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_wide_groups_match_jax(R, H, K, hd, ps, mpr, window,
                                           softcap, dtype):
    """Query groups wider than one block of the card's kernel: G hd 4096
    (recurrentgemma-2b's 16 padded q heads of 256 over one kv head), 2560
    (its 10 real heads) and 2048."""
    case = paged_case(R, H, K, hd, ps, mpr, dtype, R * mpr + 3)
    (qj, qt), (kj, kt), (vj, vt), (pj, ptt), (lj, lt) = case
    ot = paged_decode_attention(qt, kt, vt, ptt, lt, window=window,
                                softcap=softcap)
    for impl in ("pallas", "ref"):
        kw = {"interpret": True} if impl == "pallas" else {}
        oj = jax_paged(qj, kj, vj, pj, lj, window=window, softcap=softcap,
                       impl=impl, **kw)
        _close(ot, oj, DTYPES[dtype][2])


def _close_grad(t: torch.Tensor, j, tol: float) -> None:
    want = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.float().numpy(), want,
                               atol=tol * float(np.abs(want).max()),
                               rtol=tol)


@pytest.mark.parametrize("shape", [(4, 64), (2, 16, 128), (33, 100)])
def test_rmsnorm_plain_gradients_match_jax(shape):
    rng = np.random.default_rng(4)
    x, w, g = (rng.standard_normal(s).astype(np.float32)
               for s in (shape, shape[-1:], shape))
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(jax_rms_norm_ref(a, b) * g),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, w))
    dx, dw = torch.autograd.grad(rms_norm_ref(xt, wt), (xt, wt),
                                 torch.from_numpy(g))
    _close_grad(dx, jdx, 1e-4)
    _close_grad(dw, jdw, 1e-4)


@pytest.mark.parametrize("S,H,K,hd", [(64, 4, 2, 16), (100, 4, 4, 32)])
@pytest.mark.parametrize("causal,window,softcap", FLASH_MODES)
def test_flash_plain_gradients_match_jax(S, H, K, hd, causal, window,
                                         softcap):
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(2, S, H, K, hd, "float32")
    g = np.random.default_rng(5).standard_normal((2, S, H, hd)).astype(
        np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jgrads = jax.grad(
        lambda a, b, c: jnp.sum(attention_ref(a, b, c, **kw) * g),
        argnums=(0, 1, 2))(qj, kj, vj)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    tgrads = torch.autograd.grad(flash_attention_ref(*leaves, **kw), leaves,
                                 torch.from_numpy(g))
    for t, j in zip(tgrads, jgrads):
        _close_grad(t, j, 1e-4)


@pytest.mark.parametrize("n", [3, 256, 1000, 4096 + 17])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_plain_matches_jax_ref(n, dtype):
    rng = np.random.default_rng(n)
    a = (rng.standard_normal(n) * 3.0).astype(np.float32)
    if n >= 512:
        a[256:512] = 0.0
    if n >= 256:
        a[:8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    xj, xt = _pair(a, dtype)
    q, s = quantize_ref(xt)
    jq, js = jax_quantize_ref(xj)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy().view(np.int32),
                          np.asarray(js, np.float32).view(np.int32))
    y = dequantize_ref(q, s, (n,))
    jy = jax_dequantize_ref(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                            (n,))
    assert np.array_equal(y.numpy().view(np.int32),
                          np.asarray(jy, np.float32).view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8",
                                   "uint8", "int32"])
def test_block_hash_words_match_jax(dtype):
    rng = np.random.default_rng(2)
    a = rng.standard_normal(777) * 100
    a = (a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16"
         else a.astype(dtype))
    t = (torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
         if dtype == "bfloat16" else torch.from_numpy(a.copy()))
    got = words_view(t).numpy()
    want = np.asarray(jax_words_view(jnp.asarray(a))).view(np.uint32)
    assert np.array_equal(got, want.astype(np.int64))
    assert words_per_element(t.dtype) == 1
    assert words_per_element(torch.float64) == 2


@pytest.mark.parametrize("M,K,N", [(8, 16, 8), (33, 70, 21)])
def test_abft_plain_matches_jax_ref(M, K, N):
    rng = np.random.default_rng(M)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for got, want in zip(encode_ref(ta, tb),
                         jax_encode_ref(jnp.asarray(a), jnp.asarray(b))):
        _close(got, want, 2e-5)
    full = abft_matmul_ref(ta, tb)
    _close(full, jax_abft_ref(jnp.asarray(a), jnp.asarray(b)), 2e-5)
    for got, want in zip(residuals_ref(full),
                         jax_residuals_ref(jnp.asarray(full.numpy()))):
        _close(got, want, 2e-4)


@pytest.mark.parametrize("B,S,Di,N,h0_zero", [(1, 64, 32, 4, True),
                                              (2, 100, 64, 8, False),
                                              (1, 37, 128, 16, False),
                                              (2, 1, 16, 16, False)])
def test_selective_scan_plain_matches_jax(B, S, Di, N, h0_zero):
    """tests/test_kernels.py's draws, from numpy: x, B, C ~ N(0, 1), dt =
    softplus(N(0, 1)) / 10, A = -exp(N(0, 1) / 5), h0 ~ N(0, 1) / 10."""
    rng = np.random.default_rng(S)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x, bm, cm = randn(B, S, Di), randn(B, S, N), randn(B, S, N)
    dt = (np.logaddexp(randn(B, S, Di), 0.0) * 0.1).astype(np.float32)
    a = -np.exp(randn(Di, N) * 0.2).astype(np.float32)
    h0 = np.zeros((B, Di, N), np.float32) if h0_zero else randn(B, Di, N) * 0.1
    args = (x, dt, bm, cm, a, h0)
    y, h = selective_scan(*(torch.from_numpy(t) for t in args))
    assert y.dtype == h.dtype == torch.float32
    jargs = [jnp.asarray(t) for t in args]
    for want_y, want_h in (jax_scan(*jargs, interpret=True),
                           jax_scan_ref(*jargs)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h),
                                   atol=1e-5, rtol=1e-5)
    ty, th = selective_scan_ref(*(torch.from_numpy(t) for t in args))
    assert torch.equal(ty, y) and torch.equal(th, h)
