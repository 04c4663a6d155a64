"""The other model families against the JAX package on the CPU:
gemma-7b, recurrentgemma-2b (RG-LRU), qwen2-vl-2b (M-RoPE, embedding
inputs, padded heads), hubert-xlarge (bidirectional encoder, embedding
inputs), phi3.5-moe and qwen1.5-110b.

``params_from_jax`` carries one JAX ``init_params`` pytree over, so both
packages compute the same function.  float32 logits agree within 1e-4 of
the largest magnitude (XLA and PyTorch sum in other orders; the RG-LRU
recurrence runs another tree of the same combine); bfloat16 within 2e-2
of it (the two frameworks round at other places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as JAX_ALL_ARCHS
from repro.core import FaultInjector as JaxFaultInjector
from repro.layers.rope import apply_mrope as jax_apply_mrope
from repro.models import forward as jax_forward
from repro.models import get_config as jax_get_config
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models.rglru import rec_apply as jax_rec_apply
from repro.models.rglru import rec_cache_init as jax_rec_cache_init
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import ALL_ARCHS
from repro_torch.core import FaultInjector
from repro_torch.launch import serve as serve_cli
from repro_torch.layers.rope import apply_mrope
from repro_torch.models import (forward, get_config, init_cache,
                                init_params, params_from_jax)
from repro_torch.models.rglru import rec_apply, rec_cache_init
from repro_torch.serve import ServeEngine

NEW = ("gemma-7b", "recurrentgemma-2b", "qwen2-vl-2b", "hubert-xlarge",
       "phi3.5-moe-42b-a6.6b", "qwen1.5-110b")
DECODERS = tuple(a for a in NEW if a != "hubert-xlarge")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fields that name the framework's execution, not the model
_EXEC = {"param_dtype", "dtype", "use_pallas", "scan_layers", "remat"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers beside
    timing-sensitive multi-process tests, and idle OpenMP threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, dtype="float32", **kw):
    jdt, tdt = DT[dtype]
    jcfg = dataclasses.replace(jax_get_config(arch, tiny=True), dtype=jdt,
                               **kw)
    kw.pop("scan_layers", None)
    tcfg = dataclasses.replace(get_config(arch, tiny=True), dtype=tdt, **kw)
    if jcfg.num_experts:                    # no capacity drops
        jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
        tcfg = dataclasses.replace(tcfg, capacity_factor=8.0)
    return jcfg, tcfg


def _jfwd(jcfg, mode):
    """The reference's forward under ``jit`` (op-by-op dispatch of a tiny
    model costs several times its compile): (logits, cache)."""
    return jax.jit(lambda p, b, c=None: jax_forward(jcfg, p, b, mode=mode,
                                                    cache=c)[:2])


def _carry(jcfg, tcfg, seed=0):
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda x: np.asarray(jax.device_get(x)), jparams)
    return jparams, params_from_jax(tcfg, tree, device="cpu")


def _mrope_ids(B, text, grid, tail):
    """(3, B, S) Qwen2-VL ids: ``text`` tokens, an image of grid x grid
    patches at one temporal step (rows and columns from the text's end),
    then ``tail`` tokens from the largest id + 1."""
    t = np.arange(text)
    h, w = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    img = np.stack([np.full(grid * grid, text), text + h.ravel(),
                    text + w.ravel()])
    after = text + grid + np.arange(tail)
    ids = np.concatenate([np.stack([t, t, t]), img,
                          np.stack([after, after, after])], axis=1)
    return np.broadcast_to(ids[:, None], (3, B, ids.shape[1])).astype(
        np.int32).copy()


def _inputs(cfg, B, S, seed=7, positions=None):
    """numpy inputs for both packages: tokens or embeddings, and M-RoPE
    ids (text ids on all three axes unless given)."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.embedding_inputs:
        b["embeddings"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    if cfg.mrope_sections:
        b["positions"] = (positions if positions is not None else
                          np.broadcast_to(np.arange(S, dtype=np.int32),
                                          (3, B, S)).copy())
    return b


def _jax_batch(b, jcfg):
    out = {k: jnp.asarray(v) for k, v in b.items()}
    if "embeddings" in out:
        out["embeddings"] = out["embeddings"].astype(jcfg.dtype)
    return out


def _torch_batch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    if "tokens" in out:
        out["tokens"] = out["tokens"].long()
    return out


def _close(got, want, tol):
    want = np.asarray(jax.device_get(want)).astype(np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), err


def test_configs_match_the_reference():
    assert ALL_ARCHS == JAX_ALL_ARCHS
    for arch in ALL_ARCHS:
        for tiny in (False, True):
            j, t = jax_get_config(arch, tiny=tiny), get_config(arch, tiny=tiny)
            tf = {f.name for f in dataclasses.fields(t)}
            for f in dataclasses.fields(j):
                if f.name in _EXEC:
                    continue
                assert f.name in tf, (arch, f.name)
                assert getattr(t, f.name) == getattr(j, f.name), \
                    (arch, tiny, f.name)
            assert t.num_params() == j.num_params(), (arch, tiny)
            assert t.effective_num_heads == j.effective_num_heads
            assert t.has_decode == j.has_decode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW)
def test_tiny_logits_match_the_reference(arch, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    jparams, tparams = _carry(jcfg, tcfg)
    B = 2
    pos = _mrope_ids(B, 3, 3, 4) if tcfg.mrope_sections else None
    S = pos.shape[2] if pos is not None else 12
    b = _inputs(tcfg, B, S, positions=pos)
    jl, _ = _jfwd(jcfg, "train")(jparams, _jax_batch(b, jcfg))
    with torch.no_grad():
        tl, _ = forward(tcfg, tparams, _torch_batch(b), mode="prefill")
    assert tl.shape == (B, S, tcfg.padded_vocab)
    _close(tl, jl, TOL[dtype])


def test_recurrentgemma_stacked_blocks_carry_across():
    """The full config's layout at tiny width: 26 layers stacked as 2
    blocks of the 13-layer pattern (the reference's scan_layers)."""
    full = jax_get_config("recurrentgemma-2b")
    jcfg, tcfg = _configs("recurrentgemma-2b", num_layers=26,
                          pattern=full.pattern, scan_layers=True)
    jparams, tparams = _carry(jcfg, tcfg)
    assert jparams["blocks"]["l12"]["rec"]["lam"].shape[0] == 2
    assert len(tparams["layers"]) == 26
    assert tparams["layers"][25]["rec"]["lam"].dtype == torch.float32
    b = _inputs(tcfg, 1, 10)
    jl, _ = _jfwd(jcfg, "train")(jparams, _jax_batch(b, jcfg))
    with torch.no_grad():
        tl, _ = forward(tcfg, tparams, _torch_batch(b), mode="prefill")
    _close(tl, jl, TOL["float32"])


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_decode_matches_full_forward(arch):
    """The twin of tests/test_models.py's: prefill S - 1 positions into a
    cache, decode the last one: the full forward's last logits, within
    float32 rounding; qwen2-vl with an image's (t, h, w) ids, whose
    rotary positions differ from the cache slots.  The decode's logits
    also equal the reference's decode on the same cache (text ids: the
    reference's decode writes its cache at the M-RoPE temporal id)."""
    jcfg, tcfg = _configs(arch)
    jparams, tparams = _carry(jcfg, tcfg)
    B = 2
    for real_ids in ((False, True) if tcfg.mrope_sections else (False,)):
        pos = _mrope_ids(B, 4, 3, 3) if real_ids else None
        S = pos.shape[2] if pos is not None else 12
        b = _torch_batch(_inputs(tcfg, B, S, positions=pos))

        def cut(sl):
            return {k: (v[:, :, sl] if k == "positions" else v[:, sl])
                    for k, v in b.items()}

        with torch.no_grad():
            full, _ = forward(tcfg, tparams, b, mode="prefill")
            cache = init_cache(tcfg, B, S, "cpu")
            forward(tcfg, tparams, cut(slice(0, S - 1)), mode="prefill",
                    cache=cache)
            dl, cache = forward(tcfg, tparams, cut(slice(S - 1, S)),
                                mode="decode", cache=cache)
        assert cache["index"].tolist() == [S] * B
        torch.testing.assert_close(dl[:, 0], full[:, -1], atol=1e-4,
                                   rtol=1e-4)
        if real_ids:
            continue
        nb = {k: v.numpy() for k, v in b.items()}
        jcut = {k: (v[:, :, :S - 1] if k == "positions" else v[:, :S - 1])
                for k, v in nb.items()}
        jdec = {k: (v[:, :, S - 1:] if k == "positions" else v[:, S - 1:])
                for k, v in nb.items()}
        _, jc = _jfwd(jcfg, "prefill")(jparams, _jax_batch(jcut, jcfg),
                                       jax_init_cache(jcfg, B, S))
        jl, _ = _jfwd(jcfg, "decode")(jparams, _jax_batch(jdec, jcfg), jc)
        _close(dl, jl, TOL["float32"])


def test_padded_heads_are_masked_as_in_the_reference():
    """No tiny config pads: pad tiny qwen2-vl's 4 q heads (2 KV groups)
    to 8 on both packages.  The port equals the reference, and equals the
    unpadded model built from the padded one's real heads."""
    jcfg, tcfg = _configs("qwen2-vl-2b", pad_heads_to=8)
    assert tcfg.effective_num_heads == 8
    jparams, tparams = _carry(jcfg, tcfg)
    assert tuple(tparams["layers"][0]["attn"]["wq"].shape) == (64, 8, 16)
    b = _inputs(tcfg, 2, 9, positions=_mrope_ids(2, 2, 2, 3))
    jl, _ = _jfwd(jcfg, "train")(jparams, _jax_batch(b, jcfg))
    with torch.no_grad():
        tl, _ = forward(tcfg, tparams, _torch_batch(b), mode="prefill")
    _close(tl, jl, TOL["float32"])
    # the real heads: the first 2 of each group of 4
    real = torch.tensor([0, 1, 4, 5])
    plain = dict(tparams, layers=[])
    for layer in tparams["layers"]:
        a = dict(layer["attn"])
        a["wq"], a["bq"], a["wo"] = a["wq"][:, real], a["bq"][real], \
            a["wo"][real]
        plain["layers"].append(dict(layer, attn=a))
    ucfg = dataclasses.replace(tcfg, pad_heads_to=0)
    with torch.no_grad():
        ul, _ = forward(ucfg, plain, _torch_batch(b), mode="prefill")
    torch.testing.assert_close(ul, tl, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_rec_apply_matches_the_reference(with_state):
    """One RG-LRU layer at S 300 (past the 128-step chunk: one chunk of
    300, as the reference takes an S that 128 does not divide) and at S
    256 (two chunks), from a zero or a carried state, then one decode
    step: outputs and states within float32 rounding."""
    jcfg, tcfg = _configs("recurrentgemma-2b")
    jparams, tparams = _carry(jcfg, tcfg)
    jp = jparams["layers"]["layer_0"]
    tp = tparams["layers"][0]
    rec = jax.jit(lambda p, x, c: jax_rec_apply(p, x, jcfg, c))
    rng = np.random.default_rng(3)
    for S in (300, 256):
        x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
        jc = jax_rec_cache_init(jcfg, 2)
        tc = rec_cache_init(tcfg, 2, "cpu")
        if with_state:
            h = rng.standard_normal((2, tcfg.d_model)).astype(np.float32)
            conv = rng.standard_normal(tuple(tc["conv"].shape)).astype(
                np.float32)
            jc = {"conv": jnp.asarray(conv), "h": jnp.asarray(h)}
            tc = {"conv": torch.from_numpy(conv.copy()),
                  "h": torch.from_numpy(h.copy())}
        jy, jc = rec(jp, jnp.asarray(x), jc)
        with torch.no_grad():
            ty = rec_apply(tp, torch.from_numpy(x), tcfg, tc)
        _close(ty, jy, TOL["float32"])
        _close(tc["h"], jc["h"], TOL["float32"])
        _close(tc["conv"], jc["conv"], TOL["float32"])
        x1 = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        jy, jc = rec(jp, jnp.asarray(x1), jc)
        with torch.no_grad():
            ty = rec_apply(tp, torch.from_numpy(x1), tcfg, tc)
        _close(ty, jy, TOL["float32"])
        _close(tc["h"], jc["h"], TOL["float32"])


def test_apply_mrope_matches_the_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = _mrope_ids(2, 7, 5, 8)
    for sections, theta in (((2, 3, 3), 1e6), ((4, 2, 2), 1e4)):
        want = jax_apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections,
                               theta)
        got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                          sections, theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-6, atol=2e-6)
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (2, 2, 2))


def _run(engine, prompts, gen):
    rids = [engine.submit(p, gen) for p in prompts]
    try:
        results = engine.run()
    finally:
        engine.shutdown()
    return [results[r] for r in rids], engine


def test_recurrentgemma_engine_kill_matches_the_reference():
    """Tiny recurrentgemma (RG-LRU rows and rolling LOCAL rows in the slot
    pool, window 8) through both engines, replica 1 killed at step 3:
    nothing dropped, the streams equal each other and the kill-free
    run's."""
    jcfg, tcfg = _configs("recurrentgemma-2b")
    jparams, tparams = _carry(jcfg, tcfg)
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(0, tcfg.vocab_size, int(n))]
               for n in rng.integers(5, 16, 6)]
    kw = dict(num_replicas=2, slots_per_replica=2, max_len=24,
              fault_tolerant=True, heartbeat_period=0.05,
              heartbeat_timeout_factor=40.0)
    jinj, tinj = JaxFaultInjector(), FaultInjector()
    jinj.schedule_replica_kill(3, replica_id=1)
    tinj.schedule_replica_kill(3, replica_id=1)
    want, _ = _run(JaxServeEngine(jcfg, jparams, fault_injector=jinj, **kw),
                   prompts, 6)
    clean, eng = _run(ServeEngine(tcfg, tparams, device="cpu", **kw),
                      prompts, 6)
    assert not eng.paged
    got, eng = _run(ServeEngine(tcfg, tparams, device="cpu",
                                fault_injector=tinj, **kw), prompts, 6)
    assert got == want == clean
    assert eng.scheduler.failed_rids == []
    assert [e["event"] for e in eng.events].count("replica_failed") == 1


def test_engine_refuses_what_the_reference_refuses(capsys):
    for arch in ("qwen2-vl-2b", "hubert-xlarge"):
        jcfg, tcfg = _configs(arch)
        jparams, tparams = _carry(jcfg, tcfg)
        with pytest.raises(ValueError) as want:
            JaxServeEngine(jcfg, jparams)
        with pytest.raises(ValueError) as got:
            ServeEngine(tcfg, tparams, device="cpu")
        assert str(got.value) == str(want.value)
        assert serve_cli.main(["--arch", arch, "--tiny", "--device",
                               "cpu"]) == 1
    out = capsys.readouterr().out
    assert "hubert-xlarge is encoder-only; no decode loop" in out
    assert "qwen2-vl-2b takes embedding inputs" in out
    # an M-RoPE stack does not page (text-only M-RoPE ids would, but the
    # reference keeps it on the slot pool)
    mcfg = dataclasses.replace(get_config("qwen2-vl-2b", tiny=True),
                               embedding_inputs=False)
    eng = ServeEngine(mcfg, init_params(mcfg, seed=0, device="cpu"),
                      device="cpu")
    assert not eng.paged
    eng.shutdown()
    with pytest.raises(ValueError, match="M-RoPE"):
        ServeEngine(mcfg, init_params(mcfg, seed=0, device="cpu"),
                    device="cpu", paged=True)
