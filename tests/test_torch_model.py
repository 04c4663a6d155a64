"""The port's dense decoder against the JAX package's on the CPU.

``params_from_jax`` carries one JAX ``init_params`` pytree over, so both
packages compute the same function.  Prefill logits and the filled cache
rows, then three ``paged_decode`` steps over one page pool (filled from
the same numpy arrays on both sides), are compared: within 1e-4 in float32
(XLA and PyTorch sum in different orders) and 2e-2 in bfloat16.  In
bfloat16 the two frameworks round at different places (XLA fuses the
elementwise ops between two roundings), so a value near zero carries the
rounding error of the hidden state it came from: there the absolute
tolerance is 2e-2 of the tensor's largest magnitude.
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
from repro.models.base import FULL as JAX_FULL
from repro.models.base import LOCAL as JAX_LOCAL
from repro_torch.models import (FULL, LOCAL, forward, get_config, init_cache,
                                params_from_jax)

PS, MPR = 4, 6                       # page size, pages per row
CACHE_LEN = PS * MPR
PROMPTS = ([7, 3, 99, 12, 5, 41, 8, 200, 17, 64, 2, 31],
           [5, 9, 250, 4, 1, 77, 6])
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tiny granite as registered, and a variant with a local/global pattern, a
# sliding window and both softcaps (the window is shorter than the prompt,
# so LOCAL prefill rows roll)
VARIANTS = {
    "granite": ({}, {}),
    "local_softcap": (
        dict(pattern=(JAX_LOCAL, JAX_FULL), window=8, attn_softcap=20.0,
             final_softcap=30.0),
        dict(pattern=(LOCAL, FULL), window=8, attn_softcap=20.0,
             final_softcap=30.0)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers beside
    timing-sensitive multi-process tests, and idle OpenMP threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(variant, dtype, use_pallas=False):
    jkw, tkw = VARIANTS[variant]
    jdt, tdt = DT[dtype]
    jcfg = dataclasses.replace(jax_get_config("granite-3-8b", tiny=True),
                               dtype=jdt, use_pallas=use_pallas, **jkw)
    tcfg = dataclasses.replace(get_config("granite-3-8b", tiny=True),
                               dtype=tdt, **tkw)
    return jcfg, tcfg


def _np(x):
    return np.asarray(jax.device_get(x)).astype(np.float32)


def _close(t, j, tol):
    want = _np(j)
    # bfloat16 (tol 2e-2): the absolute tolerance follows the tensor's scale
    atol = tol * max(1.0, float(np.abs(want).max())) if tol > 1e-3 else tol
    np.testing.assert_allclose(t.float().numpy(), want, atol=atol, rtol=tol)


def _jax_layer(cache, cfg, i, name):
    P_ = len(cfg.pattern)
    return cache["blocks"][f"l{i % P_}"][name][i // P_]


def _to_jax(a, dtype):
    return jnp.asarray(a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16"
                       else a)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype,use_pallas", [("float32", False),
                                              ("float32", True),
                                              ("bfloat16", False)])
def test_prefill_and_paged_decode_match_jax(variant, dtype, use_pallas):
    jcfg, tcfg = _configs(variant, dtype, use_pallas)
    tol = TOL[dtype]
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    tree = jax.tree.map(lambda x: np.asarray(jax.device_get(x)), jparams)
    tparams = params_from_jax(tcfg, tree, device="cpu")
    L, K, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.resolved_head_dim

    # --- prefill: logits and the filled cache row, per prompt ----------
    rows, first = [], []
    for prompt in PROMPTS:
        toks = np.asarray([prompt], np.int32)
        jl, jc, _ = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                                mode="prefill",
                                cache=jax_init_cache(jcfg, 1, CACHE_LEN))
        with torch.no_grad():
            tl, tc = forward(tcfg, tparams,
                             {"tokens": torch.from_numpy(toks).long()},
                             mode="prefill",
                             cache=init_cache(tcfg, 1, CACHE_LEN, "cpu"))
        _close(tl, jl, tol)
        for i in range(L):
            for name in ("k", "v"):
                _close(tc["layers"][i][name], _jax_layer(jc, jcfg, i, name),
                       tol)
            np.testing.assert_array_equal(
                tc["layers"][i]["pos"][0].numpy(),
                np.asarray(_jax_layer(jc, jcfg, i, "pos")))
        rows.append([{n: _np(_jax_layer(jc, jcfg, i, n))
                      for n in ("k", "v", "pos")} for i in range(L)])
        first.append(int(np.argmax(_np(jl)[0, -1, :jcfg.vocab_size])))

    # --- one page pool, filled from the JAX rows on both sides -----------
    R = len(PROMPTS)
    num_pages = R * MPR + 1
    tables = np.arange(1, num_pages, dtype=np.int32).reshape(R, MPR)
    pool = {n: np.zeros((L, num_pages, PS, K, hd), np.float32)
            for n in ("k", "v")}
    for r, (prompt, row) in enumerate(zip(PROMPTS, rows)):
        for i in range(L):
            pos = row[i]["pos"].astype(np.int64)
            for t in range(len(prompt)):
                slot = t % pos.shape[0]
                if pos[slot] == t:               # rolled-out positions: 0
                    for n in ("k", "v"):
                        pool[n][i, tables[r, t // PS], t % PS] = \
                            row[i][n][0, slot]
    P_ = len(jcfg.pattern)
    jpool = {"blocks": {f"l{p}": {n: _to_jax(pool[n][p::P_], dtype)
                                  for n in ("k", "v")} for p in range(P_)}}
    tpool = {n: torch.from_numpy(pool[n].copy()).to(DT[dtype][1])
             for n in ("k", "v")}

    # --- three paged decode steps --------------------------------------
    lengths = np.asarray([len(p) for p in PROMPTS], np.int32)
    tokens = np.asarray(first, np.int32)[:, None]
    for _ in range(3):
        batch = {"tokens": tokens, "lengths": lengths, "page_tables": tables}
        jl, jpool, _ = jax_forward(
            jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
            mode="paged_decode", cache=jpool)
        with torch.no_grad():
            tl, tpool = forward(
                tcfg, tparams,
                {"tokens": torch.from_numpy(tokens).long(),
                 "lengths": torch.from_numpy(lengths),
                 "page_tables": torch.from_numpy(tables)},
                mode="paged_decode", cache=tpool)
        _close(tl, jl, tol)
        tokens = np.argmax(_np(jl)[:, -1, :jcfg.vocab_size],
                           axis=-1).astype(np.int32)[:, None]
        lengths = lengths + 1
    for i in range(L):
        for n in ("k", "v"):
            _close(tpool[n][i], jpool["blocks"][f"l{i % P_}"][n][i // P_],
                   tol)


def test_params_from_jax_unstacks_layers_and_casts_once():
    jcfg, tcfg = _configs("local_softcap", "bfloat16")
    tree = jax.tree.map(lambda x: np.asarray(jax.device_get(x)),
                        jax_init_params(jcfg, jax.random.PRNGKey(1)))
    params = params_from_jax(tcfg, tree, device="cpu")
    assert len(params["layers"]) == tcfg.num_layers
    for i, layer in enumerate(params["layers"]):
        want = tree["blocks"][f"l{i % 2}"]["attn"]["wq"][i // 2]
        got = layer["attn"]["wq"]
        assert got.dtype == torch.bfloat16          # cast once, at load
        np.testing.assert_array_equal(
            got.float().numpy(),
            want.astype(ml_dtypes.bfloat16).astype(np.float32))
    assert params["embed"]["tok"].shape == (tcfg.padded_vocab,
                                            tcfg.d_model)
