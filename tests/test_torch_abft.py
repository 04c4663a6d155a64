"""The port's SDC tier 1 (ABFT: checksum-extended matmuls) against the
JAX package's, on the CPU.

The same numpy inputs go through the reference's ``abft_matmul`` (its
Pallas kernel in interpret mode, as tests/test_kernels.py runs it) and
the port's plain version.  C is held to 1e-5 (float32 sums in another
order); every report field is held exactly (detected, corrected, the
flagged row and column, the residual counts), the correction to 1e-4
relative.  ``abft_dot``'s value and gradients, ``mlp_apply(impl="abft")``
and a whole train step with ``impl="abft"`` are held to the reference's
to 1e-4 in float32 and 2e-2 of the largest magnitude in bfloat16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data import make_pipeline as jax_make_pipeline
from repro.kernels.abft_matmul.ops import abft_dot as jax_abft_dot
from repro.kernels.abft_matmul.ops import abft_matmul as jax_abft_matmul
from repro.kernels.abft_matmul.ops import \
    verify_and_correct as jax_verify_and_correct
from repro.kernels.abft_matmul.ref import residuals_ref as jax_residuals
from repro.layers.mlp import mlp_apply as jax_mlp_apply
from repro.models import get_config as jax_get_config
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.kernels.abft_matmul.ops import (abft_dot, abft_matmul,
                                                 detections,
                                                 reset_detections,
                                                 verify_and_correct)
from repro_torch.kernels.abft_matmul.ref import (abft_matmul_ref,
                                                 residuals_ref)
from repro_torch.layers.mlp import mlp_apply
from repro_torch.models import get_config, state_from_jax
from repro_torch.train import make_train_step
from repro_torch.tree import flatten_named

FIELDS = ("detected", "corrected", "row", "col", "bad_rows", "bad_cols")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


def _assert_report(rep, jrep):
    for f in FIELDS:
        assert int(rep[f]) == int(jrep[f]), f
    np.testing.assert_allclose(float(rep["delta"]), float(jrep["delta"]),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("M,K,N", [(8, 16, 8), (64, 96, 80), (130, 200, 72)])
def test_clean_product_matches_reference(M, K, N):
    a, b = _inputs(M, K, N)
    jc, jrep = jax_abft_matmul(jnp.asarray(a), jnp.asarray(b),
                               interpret=True)
    c, rep = abft_matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    _assert_report(rep, jrep)
    assert not bool(rep["detected"]) and not bool(rep["corrected"])
    full = abft_matmul_ref(torch.from_numpy(a), torch.from_numpy(b))
    for got, want in zip(residuals_ref(full),
                         jax_residuals(jnp.asarray(full.numpy()))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4)


@pytest.mark.parametrize("inject", [
    (3, 7, 50.0), (0, 0, -200.0), (63, 79, 17.5),     # data elements
    (64, 7, 50.0), (5, 80, 50.0),                      # checksum row/col
    (10, 20, 1e-7)])                                   # below the noise
@pytest.mark.parametrize("correct", [True, False])
def test_injected_error_report_matches_reference(inject, correct):
    a, b = _inputs(64, 96, 80, seed=1)
    jc, jrep = jax_abft_matmul(jnp.asarray(a), jnp.asarray(b),
                               inject=inject, correct=correct,
                               interpret=True)
    reset_detections()
    c, rep = abft_matmul(torch.from_numpy(a), torch.from_numpy(b),
                         inject=inject, correct=correct)
    _assert_report(rep, jrep)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-4)
    assert detections("cpu") == int(bool(rep["detected"]))
    clean = (a.astype(np.float64) @ b).astype(np.float32)
    if inject[2] > 1.0 and inject[0] < 64 and inject[1] < 80:
        # a data element: located, and corrected iff asked
        assert bool(rep["detected"]) and bool(rep["corrected"])
        assert (int(rep["row"]), int(rep["col"])) == inject[:2]
        if correct:
            np.testing.assert_allclose(c.numpy(), clean, rtol=1e-5,
                                       atol=1e-4)


def test_double_error_detected_not_corrected():
    a, b = _inputs(64, 96, 80, seed=2)
    full = abft_matmul_ref(torch.from_numpy(a), torch.from_numpy(b))
    full[2, 3] += 40.0
    full[5, 9] -= 30.0
    _, rep = verify_and_correct(full)
    _, jrep = jax_verify_and_correct(jnp.asarray(full.numpy()))
    _assert_report(rep, jrep)
    assert bool(rep["detected"]) and not bool(rep["corrected"])
    assert int(rep["bad_rows"]) == 2 and int(rep["bad_cols"]) == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_abft_dot_value_and_gradients_match_reference(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 80)) * 0.1).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        w = w.astype(ml_dtypes.bfloat16).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2

    def jloss(x_, w_):
        return jnp.sum(jax_abft_dot(x_, w_).astype(jnp.float32) ** 2)

    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    jy = jax_abft_dot(jx, jw)
    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jx, jw)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    ty = abft_dot(tx, tw)
    assert ty.dtype == tdt and tuple(ty.shape) == (2, 16, 80)
    (ty.float() ** 2).sum().backward()
    for got, want in ((ty, jy), (tx.grad, jgx), (tw.grad, jgw)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(
            got.detach().float().numpy(), want, rtol=tol,
            atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu_plain"])
def test_mlp_abft_matches_reference(act, dtype):
    rng = np.random.default_rng(5)
    d, f = 32, 64
    p = {"w_in": rng.standard_normal((d, f)) * d ** -0.5,
         "w_out": rng.standard_normal((f, d)) * f ** -0.5,
         "w_gate": rng.standard_normal((d, f)) * d ** -0.5}
    if act == "gelu_plain":
        del p["w_gate"]
    x = rng.standard_normal((2, 8, d))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    want = np.asarray(jax_mlp_apply(jp, jnp.asarray(x, jdt), act, jdt,
                                    impl="abft"), np.float32)
    tp = {k: torch.from_numpy(v.astype(np.float32)).to(tdt)
          for k, v in p.items()}
    got = mlp_apply(tp, torch.from_numpy(x.astype(np.float32)).to(tdt),
                    act, impl="abft")
    plain = mlp_apply(tp, torch.from_numpy(x.astype(np.float32)).to(tdt),
                      act)
    tol = 1e-4 if dtype == "float32" else 2e-2
    scale = float(np.abs(want).max())
    for y in (got, plain):
        np.testing.assert_allclose(y.float().numpy(), want, rtol=tol,
                                   atol=tol * scale)


def test_abft_train_step_matches_reference():
    """One float32 step of tiny granite with ``impl="abft"``: loss, grad
    norm and every parameter against the reference's abft step and the
    port's plain step."""
    jcfg = dataclasses.replace(jax_get_config("granite-3-8b", tiny=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config("granite-3-8b", tiny=True),
                               dtype=torch.float32)
    jstate = jax_init_state(jcfg, jax.random.PRNGKey(0))
    tstate = state_from_jax(tcfg, jax.device_get(jstate), device="cpu")
    batch = jax.device_get(jax_make_pipeline(jcfg, 16, 2).next_batch())
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    jnew, jm = jax.jit(jax_make_train_step(jcfg, total_steps=4,
                                           impl="abft"))(jstate, batch)
    reset_detections()
    tnew, tm = make_train_step(tcfg, total_steps=4, impl="abft")(tstate,
                                                                 tbatch)
    assert detections("cpu") == 0
    pnew, pm = make_train_step(tcfg, total_steps=4)(tstate, tbatch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
        np.testing.assert_allclose(float(tm[k]), float(pm[k]), rtol=1e-4)
    jflat = dict(flatten_named(jax.device_get(jnew)))
    for name, t in flatten_named(tnew):
        if name.startswith("params."):
            np.testing.assert_allclose(t.numpy(), np.asarray(jflat[name]),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
