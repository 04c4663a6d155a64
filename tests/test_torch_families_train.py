"""The new families' gradients in the port against ``jax.grad`` of the
reference's ``loss_fn`` on the CPU (one torch thread, as
tests/test_torch_train.py).

gemma-7b, recurrentgemma-2b (RG-LRU, LOCAL attention over one kv head;
the reference's unstacked 5-layer tiny config and a stacked 6-layer
variant), qwen2-vl-2b (embedding inputs, M-RoPE over an image's ids),
hubert-xlarge (bidirectional encoder, frame targets), phi3.5-moe and
qwen1.5-110b: train-mode logits, the loss and every gradient leaf.  In
float32 every tensor is held elementwise to 1e-4 (XLA and PyTorch sum in
other orders; the RG-LRU recurrence takes another tree of the same
combine).  In bfloat16 the two frameworks round at other places, so
the port is held to the float32 reference: logits and loss within 2e-2
of the largest magnitude, the logits and each gradient as close to it as
the reference's own bfloat16 result (relative L2, 1.25x + 1e-3).
phi3.5-moe's routing is discrete: a bfloat16 rounding flips a token's
expert choice on one side or the other, and the flip moves every
gradient.  At this seed the port's bfloat16 flips one token's choice
(sequence 0 from position 10 on leaves 2e-2; logits 6.0 % and the whole
gradient 6.7 % from float32, the reference's 1.0 % and 1.8 %); at seeds
1 and 2 its per-leaf error is 0.96-0.99 of the reference's (median; at
most 1.19), and tests/test_torch_moe.py saw the reference flip where the
port did not.  So an MoE stack's bfloat16 logits and whole gradient are
held to 10 % of float32 (relative L2), its loss to 2e-2; float32 holds
every element to 1e-4.  An RG-LRU stack's
recurrence carries each side's rounding through every step, and one
leaf's error then swings far from leaf to leaf: over seeds 0-3 the
port's per-leaf error over the reference's has a median of 0.97-1.16
but reaches 1.47 (stacked) and 1.69 (unstacked) on single leaves of
either layout (gemma-7b: 1.04-1.16 at most).  There the gradient is held
as a whole (every leaf in one vector) to 1.25x + 1e-3 of the
reference's error, and each leaf to 2x.  Padded q heads get exactly
zero gradients in both packages.  ``linear_scan``'s gradient is held to
``jax.grad`` of the reference's ``_scan_chunked``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import forward as jax_forward
from repro.models.mamba import _scan_chunked
from repro.train import loss_fn as jax_loss_fn
from repro_torch.models import forward
from repro_torch.models.rglru import linear_scan
from repro_torch.train import loss_fn
from repro_torch.tree import flatten_named, leaves, unflatten
from torch_family_cases import (TOL, VARIANT_IDS, VARIANTS, as_accurate,
                                close, configs, np32, padded_heads, rel,
                                setup, tbatch)


# an MoE stack in bfloat16: logits and the whole gradient against float32
# (relative L2), loose enough for one flipped expert choice
MOE_BF16_REL = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_grads(jcfg, params, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(jcfg, p, b), has_aux=True))
    (loss, _), grads = fn(params, batch)
    return loss, dict(flatten_named(jax.device_get(grads)))


def _torch_grads(tcfg, params, batch):
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, _ = loss_fn(tcfg, unflatten(params, live), tbatch(batch))
    names = [n for n, _ in flatten_named(params)]
    return loss, dict(zip(names, torch.autograd.grad(loss, live)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,extra", VARIANTS, ids=VARIANT_IDS)
def test_train_logits_loss_and_grads_match_reference(arch, extra, dtype):
    jcfg, tcfg, jstate, tstate, batches = setup(arch, dtype, extra)
    tol = TOL[dtype]
    batch = batches[0]
    jlogits = jax.jit(lambda p, b: jax_forward(jcfg, p, b, mode="train")[0])(
        jstate["params"], batch)
    tlogits, _ = forward(tcfg, tstate["params"], tbatch(batch),
                         mode="train")
    jloss, jnamed = _jax_grads(jcfg, jstate["params"], batch)
    tloss, tnamed = _torch_grads(tcfg, tstate["params"], batch)
    assert sorted(jnamed) == sorted(tnamed)
    if dtype == "float32":
        close(tlogits, jlogits, tol, "logits")
        close(tloss, jloss, tol, "loss")
        for name, g in tnamed.items():
            close(g, jnamed[name], tol, f"grad {name}")
        return
    jcfg32 = configs(arch, "float32", extra)[0]
    l32 = jax.jit(lambda p, b: jax_forward(jcfg32, p, b, mode="train")[0])(
        jstate["params"], batch)
    loss32, j32 = _jax_grads(jcfg32, jstate["params"], batch)
    close(tloss, loss32, tol, "loss")
    names = sorted(tnamed)
    whole = [np.concatenate([np32(t[n]).ravel() for n in names])
             for t in (jnamed, j32)]
    got = torch.cat([tnamed[n].float().ravel() for n in names]).numpy()
    if tcfg.num_experts:
        assert np.isfinite(got).all()
        for a, b, what in ((tlogits.float().numpy(), np32(l32), "logits"),
                           (got, whole[1], "the whole gradient")):
            assert rel(a, b) <= MOE_BF16_REL, (what, rel(a, b))
        return
    close(tlogits, l32, tol, "logits")
    as_accurate(tlogits, jlogits, l32, "logits")
    if "rec" not in tcfg.layer_kinds():
        for name, g in tnamed.items():
            as_accurate(g, jnamed[name], j32[name], f"grad {name}")
        return
    for name, g in tnamed.items():
        leaf, ref, truth = (np.asarray(x, np.float32).ravel() for x in (
            g.float().numpy(), np32(jnamed[name]), np32(j32[name])))
        assert rel(leaf, truth) <= 2 * rel(ref, truth) + 1e-3, name
    as_accurate(torch.from_numpy(got), *whole, "the whole gradient")


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen2-vl-2b"])
def test_padded_heads_get_zero_gradients(arch):
    """No tiny config pads: pad the q heads to 8 on both packages
    (recurrentgemma 4 over 1 kv head, qwen2-vl 4 over 2).  The padded
    heads' rows of wq, bq and wo get exactly zero gradients in both, and
    every gradient matches the reference."""
    jcfg, tcfg, jstate, tstate, batches = setup(
        arch, "float32", (("pad_heads_to", 8),))
    pad = padded_heads(tcfg)
    assert pad and tcfg.effective_num_heads == 8
    _, jnamed = _jax_grads(jcfg, jstate["params"], batches[0])
    _, tnamed = _torch_grads(tcfg, tstate["params"], batches[0])
    seen = 0
    for name, g in tnamed.items():
        close(g, jnamed[name], TOL["float32"], f"grad {name}")
        axis = {"wq": -2, "bq": -2, "wo": -3}.get(name.rsplit(".", 1)[-1])
        if axis is None:
            continue
        for got in (g.numpy(), np.asarray(jnamed[name])):
            assert not np.take(got, pad, axis=axis).any(), name
            assert np.take(got, [0], axis=axis).any(), name
        seen += 1
    assert seen >= 2


@pytest.mark.parametrize("S", [300, 256, 1])
def test_linear_scan_grad_matches_jax(S):
    """S 300: one chunk (128 does not divide it, as the reference takes
    it); 256: two chunks, the state carried between them; 1: a single
    step.  The outputs and the gradients of a, b and h0 under a random
    cotangent of both outputs, within 1e-4 of their largest magnitude."""
    rng = np.random.default_rng(9)
    a = rng.uniform(0.5, 0.999, (2, S, 8)).astype(np.float32)
    b, w = (rng.standard_normal((2, S, 8)).astype(np.float32)
            for _ in range(2))
    h0, w2 = (rng.standard_normal((2, 8)).astype(np.float32)
              for _ in range(2))

    def jax_loss(a_, b_, h_):
        hs, hl = _scan_chunked(a_, b_, h_)
        return jnp.sum(hs * w) + jnp.sum(hl * w2), (hs, hl)

    (_, (jhs, jhl)), jg = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    ta, tb, th = (torch.from_numpy(x.copy()).requires_grad_(True)
                  for x in (a, b, h0))
    hs, hl = linear_scan(ta, tb, th)
    tg = torch.autograd.grad((hs * torch.from_numpy(w)).sum()
                             + (hl * torch.from_numpy(w2)).sum(),
                             (ta, tb, th))
    for got, want, what in ((hs, jhs, "h_all"), (hl, jhl, "h_last"),
                            *zip(tg, jg, ("da", "db", "dh0"))):
        want = np32(want)
        got = got.detach().numpy()
        assert got.shape == want.shape, what
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), what
