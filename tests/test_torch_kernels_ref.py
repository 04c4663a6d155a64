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
reference's jnp codec reference.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ckpt_codec.ref import dequantize_ref as jax_dequantize_ref
from repro.kernels.ckpt_codec.ref import quantize_ref as jax_quantize_ref
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.paged_attention.ops import \
    paged_decode_attention as jax_paged
from repro.kernels.rmsnorm.ops import rms_norm as jax_rms_norm
from repro.kernels.rmsnorm.ref import rms_norm_ref as jax_rms_norm_ref
from repro_torch.kernels.ckpt_codec.ref import dequantize_ref, quantize_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.rmsnorm.ops import rms_norm
from repro_torch.kernels.rmsnorm.ref import rms_norm_ref

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
