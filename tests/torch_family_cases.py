"""Shared set-up of the new families' train parity tests
(``test_torch_families_train.py``, ``test_torch_families_step.py``).

Both packages start from one reference train state (``init_state``
carried over by ``state_from_jax``) and see the reference pipeline's
batches as numpy, qwen2-vl's with an image's (t, h, w) M-RoPE ids in
place of the pipeline's text ids.  The variants are the six new tiny
configs (tiny recurrentgemma in the reference's unstacked layout: 5
layers over a pattern of 3) and a 6-layer recurrentgemma that both
packages stack (two blocks of the pattern)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data import make_pipeline as jax_make_pipeline
from repro.models import get_config as jax_get_config
from repro.train import init_state as jax_init_state
from repro_torch.models import get_config, state_from_jax

NEW = ("gemma-7b", "recurrentgemma-2b", "qwen2-vl-2b", "hubert-xlarge",
       "phi3.5-moe-42b-a6.6b", "qwen1.5-110b")
STACKED_REC = ("recurrentgemma-2b", (("num_layers", 6),
                                     ("scan_layers", True)))
VARIANTS = [(a, ()) for a in NEW] + [STACKED_REC]
VARIANT_IDS = list(NEW) + ["recurrentgemma-2b-stacked"]
SEQ, BATCH = 16, 4
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def configs(arch, dtype, extra=()):
    """(reference, port) tiny configs in ``dtype`` with the ``extra``
    fields (``scan_layers`` is the reference's alone); MoE without
    capacity drops."""
    kw = dict(extra)
    jdt, tdt = DT[dtype]
    jcfg = dataclasses.replace(jax_get_config(arch, tiny=True), dtype=jdt,
                               **kw)
    kw.pop("scan_layers", None)
    tcfg = dataclasses.replace(get_config(arch, tiny=True), dtype=tdt, **kw)
    if jcfg.num_experts:
        jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
        tcfg = dataclasses.replace(tcfg, capacity_factor=8.0)
    return jcfg, tcfg


def mrope_ids(B, text, grid, tail):
    """(3, B, S) Qwen2-VL ids: ``text`` tokens, an image of grid x grid
    patches at one temporal step, then ``tail`` tokens."""
    t = np.arange(text)
    h, w = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    img = np.stack([np.full(grid * grid, text), text + h.ravel(),
                    text + w.ravel()])
    after = text + grid + np.arange(tail)
    ids = np.concatenate([np.stack([t, t, t]), img,
                          np.stack([after, after, after])], axis=1)
    return np.broadcast_to(ids[:, None], (3, B, ids.shape[1])).astype(
        np.int32).copy()


def setup(arch, dtype, extra=(), seed=0):
    """(jcfg, tcfg, reference state, port state, two numpy batches)."""
    jcfg, tcfg = configs(arch, dtype, extra)
    jstate = jax_init_state(jcfg, jax.random.PRNGKey(seed))
    tstate = state_from_jax(tcfg, jax.device_get(jstate), device="cpu")
    data = jax_make_pipeline(jcfg, SEQ, BATCH, seed=seed)
    batches = []
    for _ in range(2):
        b = {k: np.asarray(v) for k, v in
             jax.device_get(data.next_batch()).items()}
        if jcfg.mrope_sections:
            b["positions"] = mrope_ids(BATCH, 4, 3, 3)
        batches.append(b)
    return jcfg, tcfg, jstate, tstate, batches


def tbatch(b):
    """A numpy batch as the port's tensors (bfloat16 embeddings widened
    to float32 exactly: the model casts them to its dtype)."""
    return {k: torch.from_numpy(np.array(
        v, np.float32 if v.dtype == jnp.bfloat16 else v.dtype))
        for k, v in b.items()}


def np32(x):
    return np.asarray(jax.device_get(x)).astype(np.float32)


def close(t, j, tol, what=""):
    """Elementwise within ``tol``; in bfloat16 the absolute part follows
    the tensor's largest magnitude."""
    want = np32(j)
    got = t.detach().float().numpy()
    atol = tol * max(1e-30, float(np.abs(want).max())) if tol > 1e-3 else tol
    np.testing.assert_allclose(got, want, atol=atol, rtol=tol, err_msg=what)


def rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def as_accurate(t, j16, j32, what="", fn=lambda a: a):
    """The port's bfloat16 result is as close to the float32 reference as
    the reference's bfloat16 result is (ratio <= 1.25, + 1e-3)."""
    got, ref, truth = (fn(np.asarray(x, np.float32)) for x in
                       (t.detach().float().numpy(), np32(j16), np32(j32)))
    err, ref_err = rel(got, truth), rel(ref, truth)
    assert err <= 1.25 * ref_err + 1e-3, (what, err, ref_err)


def padded_heads(cfg):
    """Indices of the padded q heads (the last of each kv group)."""
    he, g = cfg.effective_num_heads, cfg.num_heads // cfg.num_kv_heads
    gp = he // cfg.num_kv_heads
    return [h for h in range(he) if h % gp >= g]
