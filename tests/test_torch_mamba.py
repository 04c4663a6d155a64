"""The port's Mamba-1 layer and stack against the JAX package on the CPU.

``params_from_jax`` carries one JAX ``init_params`` pytree of tiny
falcon-mamba over, so both packages compute the same function.  The JAX
side runs its scan both ways: the chunked associative scan
(``use_pallas=False``) and the Pallas kernel in interpret mode
(``use_pallas=True``).  Compared: ``ssm_apply`` (output and the conv and
scan state it leaves), and the whole ``forward`` in ``prefill`` and then
``decode`` mode (logits, and every layer's ``conv`` and ``h`` after the
prefill and after each decode step).  Random tiny weights repeat one
token a lot, so logits and states are compared, not only tokens.
Tolerances are those of tests/test_torch_model.py: 1e-4 elementwise in
float32 (the frameworks sum in different orders), 2e-2 of the tensor's
largest magnitude in bfloat16 (they round at different places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import forward as jax_forward
from repro.models import get_config as jax_get_config
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models.mamba import ssm_apply as jax_ssm_apply
from repro.models.transformer import _cast_params
from repro_torch.models import (forward, get_config, init_cache, init_params,
                                init_train_params, params_from_jax)
from repro_torch.models.mamba import _causal_conv, ssm_apply

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# two rows of one length (the reference's prefill is lockstep), a prompt
# shorter than the conv window (W - 1 = 3) and a one-token prompt, which
# takes the single-step branch in both packages
PROMPTS = {"rows2": [[7, 3, 99, 12, 5, 41, 8, 200, 17],
                     [5, 9, 250, 4, 1, 77, 6, 2, 31]],
           "short": [[11, 13]], "one": [[42]]}
DECODE_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers beside
    timing-sensitive multi-process tests, and idle OpenMP threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype, use_pallas=False):
    jdt, tdt = DT[dtype]
    jcfg = dataclasses.replace(jax_get_config("falcon-mamba-7b", tiny=True),
                               dtype=jdt, use_pallas=use_pallas)
    tcfg = dataclasses.replace(get_config("falcon-mamba-7b", tiny=True),
                               dtype=tdt)
    return jcfg, tcfg


def _weights(jcfg, tcfg, seed=3):
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda x: np.asarray(jax.device_get(x)), jparams)
    return jparams, params_from_jax(tcfg, tree, device="cpu")


def _np(x):
    return np.asarray(jax.device_get(x)).astype(np.float32)


def _close(t, j, tol):
    want = _np(j)
    atol = tol * max(1.0, float(np.abs(want).max())) if tol > 1e-3 else tol
    np.testing.assert_allclose(t.float().numpy(), want, atol=atol, rtol=tol)


def _to_jax(a, dtype):
    return jnp.asarray(a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16"
                       else a)


def _jax_layer(cache, i, name):
    return cache["blocks"]["l0"][name][i]


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("dtype,use_pallas", [("float32", False),
                                              ("float32", True),
                                              ("bfloat16", False)])
def test_ssm_apply_matches_jax(dtype, use_pallas, with_cache):
    jcfg, tcfg = _configs(dtype, use_pallas)
    jparams, tparams = _weights(jcfg, tcfg)
    tol = TOL[dtype]
    rng = np.random.default_rng(0)
    B, S = 2, 11
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    conv = (rng.standard_normal((B, tcfg.conv_width - 1, tcfg.d_inner))
            .astype(np.float32))
    h = (0.1 * rng.standard_normal((B, tcfg.d_inner, tcfg.ssm_state))
         ).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"]["l0"])
    jp = _cast_params(jcfg, {"l": jp})["l"]
    jcache = ({"conv": _to_jax(conv, dtype), "h": jnp.asarray(h)}
              if with_cache else None)
    jy, jc = jax_ssm_apply(jp, _to_jax(x, dtype), jcfg, jcache,
                           use_pallas=use_pallas)
    # the port updates its cache in place, so it gets buffers of its own:
    # jnp.asarray copies a numpy array to the device asynchronously, and a
    # write into the shared buffer before that copy ends reached the
    # reference's input under load
    tcache = ({"conv": torch.from_numpy(conv.copy()).to(DT[dtype][1]),
               "h": torch.from_numpy(h.copy())} if with_cache else None)
    with torch.no_grad():
        ty = ssm_apply(tparams["layers"][1],
                       torch.from_numpy(x).to(DT[dtype][1]), tcfg, tcache)
    assert ty.dtype == DT[dtype][1]
    _close(ty, jy, tol)
    if with_cache:
        _close(tcache["conv"], jc["conv"], tol)
        _close(tcache["h"], jc["h"], tol)
        assert tcache["h"].dtype == torch.float32


@pytest.mark.parametrize("prompts", sorted(PROMPTS))
@pytest.mark.parametrize("dtype,use_pallas", [("float32", False),
                                              ("float32", True),
                                              ("bfloat16", False)])
def test_prefill_and_decode_match_jax(prompts, dtype, use_pallas):
    jcfg, tcfg = _configs(dtype, use_pallas)
    jparams, tparams = _weights(jcfg, tcfg)
    tol = TOL[dtype]
    toks = np.asarray(PROMPTS[prompts], np.int32)
    B = toks.shape[0]
    L = tcfg.num_layers

    def check_cache(tc, jc):
        for i in range(L):
            for name in ("conv", "h"):
                _close(tc["layers"][i][name], _jax_layer(jc, i, name), tol)

    jl, jc, _ = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                            mode="prefill",
                            cache=jax_init_cache(jcfg, B, 32))
    with torch.no_grad():
        tl, tc = forward(tcfg, tparams,
                         {"tokens": torch.from_numpy(toks).long()},
                         mode="prefill", cache=init_cache(tcfg, B, 32, "cpu"))
    _close(tl, jl, tol)
    check_cache(tc, jc)
    nxt = np.argmax(_np(jl)[:, -1, :jcfg.vocab_size], -1).astype(np.int32)
    for _ in range(DECODE_STEPS):
        step = nxt[:, None]
        jl, jc, _ = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(step)},
                                mode="decode", cache=jc)
        with torch.no_grad():
            tl, tc = forward(tcfg, tparams,
                             {"tokens": torch.from_numpy(step).long()},
                             mode="decode", cache=tc)
        _close(tl, jl, tol)
        check_cache(tc, jc)
        nxt = np.argmax(_np(jl)[:, -1, :jcfg.vocab_size], -1).astype(np.int32)


def test_prefill_then_decode_equals_one_long_prefill():
    """prefill(p) + k decode steps give the logits and state of
    prefill(p + the k tokens): the scan's h_last and the decode step
    continue each other (float32, 1e-4 of the largest magnitude)."""
    _, tcfg = _configs("float32")
    params = init_params(tcfg, seed=1, device="cpu")
    prompt, extra = [3, 14, 15, 92, 65, 35, 89], [79, 32, 38, 46]
    with torch.no_grad():
        logits, row = forward(tcfg, params,
                              {"tokens": torch.tensor([prompt])},
                              mode="prefill",
                              cache=init_cache(tcfg, 1, 0, "cpu"))
        got = [logits[0]]
        for t in extra:
            logits, row = forward(tcfg, params, {"tokens": torch.tensor([[t]])},
                                  mode="decode", cache=row)
            got.append(logits[0])
        want, want_row = forward(tcfg, params,
                                 {"tokens": torch.tensor([prompt + extra])},
                                 mode="prefill",
                                 cache=init_cache(tcfg, 1, 0, "cpu"))
    pairs = [(torch.cat(got), want[0])] + [
        (row["layers"][i][n], want_row["layers"][i][n])
        for i in range(tcfg.num_layers) for n in ("conv", "h")]
    for a, b in pairs:
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale


def test_recurrence_leaves_stay_float32():
    """``A_log`` and ``D`` are exponentiated and added in float32 (the
    reference's ``_KEEP_FP32``): in a bf16 model they must not arrive
    rounded to bf16, through ``params_from_jax`` or ``init_params``."""
    jcfg, tcfg = _configs("bfloat16")
    tree = jax.tree.map(lambda x: np.asarray(jax.device_get(x)),
                        jax_init_params(jcfg, jax.random.PRNGKey(2)))
    for params in (params_from_jax(tcfg, tree, device="cpu"),
                   init_params(tcfg, seed=0, device="cpu")):
        for i, layer in enumerate(params["layers"]):
            s = layer["ssm"]
            assert s["A_log"].dtype == torch.float32
            assert s["D"].dtype == torch.float32
            assert s["in_proj"].dtype == torch.bfloat16     # cast once
            assert s["conv_b"].dtype == torch.bfloat16
        want = tree["blocks"]["l0"]["ssm"]["A_log"][0]
        np.testing.assert_array_equal(
            params["layers"][0]["ssm"]["A_log"].numpy(), want)


def test_init_matches_the_reference_shapes_and_scales():
    jcfg, tcfg = _configs("float32")
    tree = jax.tree.map(lambda x: np.asarray(jax.device_get(x)),
                        jax_init_params(jcfg, jax.random.PRNGKey(0)))
    params = init_params(tcfg, seed=0, device="cpu")
    for i, layer in enumerate(params["layers"]):
        for name, t in layer["ssm"].items():
            want = tree["blocks"]["l0"]["ssm"][name][i]
            assert tuple(t.shape) == want.shape, name
            if name in ("conv_b", "dt_b", "A_log", "D"):     # constants
                np.testing.assert_array_equal(t.numpy(), want)
            else:                                            # same scale
                assert 0.8 < float(t.std()) / float(want.std()) < 1.25, name
        assert layer["ln"].shape == (tcfg.d_model,)


def test_causal_conv_keeps_the_last_inputs():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    b = torch.zeros(6)
    x = torch.from_numpy(rng.standard_normal((1, 2, 6)).astype(np.float32))
    _, state = _causal_conv(x, w, b)
    assert state.shape == (1, 3, 6)
    assert torch.equal(state[:, 0], torch.zeros(1, 6))   # zero padding
    assert torch.equal(state[:, 1:], x)
    x2 = torch.from_numpy(rng.standard_normal((1, 5, 6)).astype(np.float32))
    y, state = _causal_conv(x2, w, b, state)
    assert torch.equal(state, x2[:, 2:])


def test_modes_the_mamba_slice_refuses():
    """What the port still refuses of a Mamba stack (training it no
    longer: train mode runs on the train layout, and so does a stack of
    REC layers)."""
    _, tcfg = _configs("float32")
    params = init_params(tcfg, seed=0, device="cpu")
    toks = torch.tensor([[1, 2, 3, 4]])
    logits, _ = forward(tcfg, init_train_params(tcfg, seed=0, device="cpu"),
                        {"tokens": toks}, mode="train")
    assert logits.shape == (1, 4, tcfg.padded_vocab)
    rcfg = dataclasses.replace(tcfg, pattern=("rec",), d_ff=2 * tcfg.d_model)
    rlogits, _ = forward(rcfg, init_train_params(rcfg, seed=0, device="cpu"),
                         {"tokens": toks}, mode="train")
    assert rlogits.shape == (1, 4, rcfg.padded_vocab)
    assert torch.isfinite(rlogits).all()
    with pytest.raises(ValueError, match="prompt's own length"):
        forward(tcfg, params, {"tokens": toks, "length": 2}, mode="prefill",
                cache=init_cache(tcfg, 1, 0, "cpu"))
    with pytest.raises(ValueError, match="page"):
        forward(tcfg, params, {"tokens": toks[:, :1]}, mode="paged_decode",
                cache={})
    # attention stacks decode over contiguous rows too
    gcfg = get_config("granite-3-8b", tiny=True)
    gparams = init_params(gcfg, seed=0, device="cpu")
    row = init_cache(gcfg, 1, 8, "cpu")
    logits, row = forward(gcfg, gparams, {"tokens": toks[:, :1]},
                          mode="decode", cache=row)
    assert logits.shape == (1, 1, gcfg.padded_vocab)
    assert row["index"].tolist() == [1]
    assert row["layers"][0]["pos"][0, :2].tolist() == [0, -1]
