"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need a CUDA device and skip without one (the ``gpu`` marker); on
the GPU machine::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

The file imports no JAX: the GPU machine has none.  Tolerances are those
of tests/test_kernels.py, 2e-5 in float32 and 2e-2 in bfloat16, with the
same inputs handed to the kernel and to its plain version on the card.
Gradients (the backward kernels against autograd of the plain versions)
are held to 1e-4 (float32) and 2e-2 (bfloat16) of the largest magnitude
of the plain gradient: they are sums over thousands of terms taken in
another order, and in bfloat16 the plain version rounds its intermediate
gradients where the kernels keep float32.  The checkpoint codec is held
byte for byte.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.ckpt_codec.kernel import (dequantize_blocks,
                                                   quantize_blocks)
from repro_torch.kernels.ckpt_codec.ref import dequantize_ref, quantize_ref
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bshd, flash_attention_bshd_bwd)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention.kernel import paged_attention_rhd
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.rmsnorm.kernel import rms_norm_2d, rms_norm_2d_bwd
from repro_torch.kernels.rmsnorm.ops import rms_norm
from repro_torch.kernels.rmsnorm.ref import rms_norm_ref

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(device=device, dtype=dtype)


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("rows,D", [(1, 4096), (8, 4096), (300, 4096),
                                    (5, 100), (3, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_matches_plain(cuda, rows, D, dtype):
    rng = np.random.default_rng(0)
    x = _randn(rng, (rows, D), dtype, cuda)
    w = _randn(rng, (D,), dtype, cuda)
    before = rms_norm_2d.launches
    y = rms_norm_2d(x, w)
    torch.cuda.synchronize()
    assert rms_norm_2d.launches == before + 1
    _close(y, rms_norm_ref(x, w), TOL[dtype])


@pytest.mark.parametrize("S,H,K,hd", [(128, 32, 8, 128), (300, 4, 2, 64),
                                      (100, 4, 4, 32), (17, 2, 1, 16)])
@pytest.mark.parametrize("causal,window,softcap",
                         [(True, 0, 0.0), (True, 64, 0.0), (True, 0, 30.0),
                          (False, 0, 0.0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_matches_plain(cuda, S, H, K, hd, causal, window,
                                    softcap, dtype):
    rng = np.random.default_rng(1)
    q = _randn(rng, (2, S, H, hd), dtype, cuda)
    k = _randn(rng, (2, S, K, hd), dtype, cuda)
    v = _randn(rng, (2, S, K, hd), dtype, cuda)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o = flash_attention_bshd(q, k, v, **kw)
    torch.cuda.synchronize()
    _close(o, flash_attention_ref(q, k, v, **kw), TOL[dtype])


def test_flash_row_does_not_depend_on_sequence_length(cuda):
    """Prefill pads prompts to one length: a row's output must not change
    with the padding behind it (causal attention, bit for bit)."""
    rng = np.random.default_rng(2)
    q, k, v = (_randn(rng, (1, 288, n, 128), torch.bfloat16, cuda)
               for n in (32, 8, 8))
    full = flash_attention_bshd(q, k, v)
    cut = flash_attention_bshd(q[:, :200].contiguous(),
                               k[:, :200].contiguous(),
                               v[:, :200].contiguous())
    assert torch.equal(full[:, :200], cut)


def _paged_inputs(rng, R, K, G, hd, ps, mpr, dtype, device):
    P = R * mpr + 1
    perm = rng.permutation(np.arange(1, P))
    lengths = (np.arange(R) * 7) % (mpr * ps)
    lengths[-1] = mpr * ps - 1
    lengths[0] = 0
    table = np.zeros((R, mpr), np.int32)
    for r in range(1, R):                        # row 0: inactive
        used = lengths[r] // ps + 1
        table[r, :used] = perm[r * mpr:r * mpr + used]
    q = _randn(rng, (R, K * G, hd), dtype, device)
    kp = _randn(rng, (P, ps, K, hd), dtype, device)
    vp = _randn(rng, (P, ps, K, hd), dtype, device)
    return (q, kp, vp, torch.from_numpy(table).to(device),
            torch.from_numpy(lengths.astype(np.int32)).to(device))


@pytest.mark.parametrize("R,K,G,hd,ps,mpr", [(8, 8, 4, 128, 16, 18),
                                             (5, 2, 4, 64, 8, 3),
                                             (4, 1, 4, 32, 16, 4)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0),
                                            (0, 30.0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_matches_plain(cuda, R, K, G, hd, ps, mpr, window,
                                    softcap, dtype):
    rng = np.random.default_rng(3)
    q, kp, vp, table, lengths = _paged_inputs(rng, R, K, G, hd, ps, mpr,
                                              dtype, cuda)
    kw = dict(window=window, softcap=softcap)
    o = paged_attention_rhd(q, kp, vp, table, lengths, **kw)
    torch.cuda.synchronize()
    want = paged_attention_ref(q[:, None], kp, vp, table, lengths, **kw)
    _close(o, want[:, 0], TOL[dtype])


def test_paged_row_does_not_depend_on_placement(cuda):
    """Token-identical failover: a row's output is the same bits whatever
    its row index, physical pages or neighbours."""
    rng = np.random.default_rng(4)
    q, kp, vp, table, lengths = _paged_inputs(rng, 8, 8, 4, 128, 16, 18,
                                              torch.bfloat16, cuda)
    o = paged_attention_rhd(q, kp, vp, table, lengths)
    # move row 5 to row 0 and its pages to fresh physical ids
    r, used = 5, int(lengths[5]) // 16 + 1
    kp2, vp2 = kp.clone(), vp.clone()
    fresh = torch.arange(used, device=cuda, dtype=torch.int32) + 1
    kp2[fresh.long()] = kp[table[r, :used].long()]
    vp2[fresh.long()] = vp[table[r, :used].long()]
    table2 = torch.zeros_like(table)
    table2[0, :used] = fresh
    lengths2 = torch.zeros_like(lengths)
    lengths2[0] = lengths[r]
    q2 = torch.zeros_like(q)
    q2[0] = q[r]
    o2 = paged_attention_rhd(q2, kp2, vp2, table2, lengths2)
    assert torch.equal(o2[0], o[r])


def test_kernels_raise_on_bad_inputs(cuda):
    x = torch.randn(4, 64, device=cuda)
    with pytest.raises(TypeError):
        rms_norm_2d(x, torch.ones(64, device=cuda, dtype=torch.bfloat16))
    q = torch.randn(1, 8, 4, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bshd(q, q[:, :, :2].contiguous(),
                             q[:, :, :2].contiguous())


def test_tiny_engine_on_the_card_matches_the_cpu(cuda):
    """The whole serving path in float32: kernels on the card, plain
    versions on the CPU, the same greedy streams."""
    from repro_torch.models import get_config, init_params
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("granite-3-8b", tiny=True),
                              dtype=torch.float32)
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = {"embed": {"tok": cpu["embed"]["tok"].to(cuda)},
           "final_norm": cpu["final_norm"].to(cuda),
           "layers": [{k: ({n: t.to(cuda) for n, t in v.items()}
                           if isinstance(v, dict) else v.to(cuda))
                       for k, v in layer.items()}
                      for layer in cpu["layers"]]}
    prompts = [[5, 9, 2, 77, 3, 1, 8, 100], [5, 9, 2, 77, 60],
               [5, 9, 2, 77, 3, 1, 8, 100], list(range(20, 33))]
    streams = []
    for params, device in ((cpu, "cpu"), (gpu, "cuda")):
        eng = ServeEngine(cfg, params, device=device, slots_per_replica=4,
                          max_len=32, page_size=4)
        rids = [eng.submit(p, 8) for p in prompts]
        out = eng.run()
        eng.shutdown()
        streams.append([out[r] for r in rids])
    assert streams[0] == streams[1]


def _close_grad(got, want, tol):
    want = want.float()
    atol = tol * max(1e-30, float(want.abs().max()))
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=tol)


def _codec_input(rng, n, dtype, device):
    x = rng.standard_normal(n).astype(np.float32) * 3.0
    if n >= 512:
        x[256:512] = 0.0                      # a zero block
    if n >= 256:
        # exact .5 ties: amax 127 makes the scale exactly 1.0
        x[:8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.parametrize("n", [3, 256, 257, 1000, 4096 * 3 + 17,
                               1 << 20])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_kernel_is_byte_identical(cuda, n, dtype):
    x = _codec_input(np.random.default_rng(n), n, dtype, cuda)
    before = quantize_blocks.launches
    q, s = quantize_blocks(x)
    torch.cuda.synchronize()
    assert quantize_blocks.launches == before + 1
    q_ref, s_ref = quantize_ref(x)
    assert torch.equal(q, q_ref)
    assert torch.equal(s.view(torch.int32), s_ref.view(torch.int32))
    y = dequantize_blocks(q, s, (n,))
    assert torch.equal(y.view(torch.int32),
                       dequantize_ref(q, s, (n,)).view(torch.int32))


def test_quantize_matches_the_cpu_plain_version(cuda):
    x = _codec_input(np.random.default_rng(7), 5000, torch.float32, cuda)
    q, s = quantize_blocks(x)
    q_cpu, s_cpu = quantize_ref(x.cpu())
    assert torch.equal(q.cpu(), q_cpu)
    assert torch.equal(s.cpu().view(torch.int32), s_cpu.view(torch.int32))


@pytest.mark.parametrize("rows,D", [(8, 4096), (300, 4096), (5, 100),
                                    (64, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [5, 6])
def test_rmsnorm_backward_matches_autograd(cuda, rows, D, dtype, seed):
    rng = np.random.default_rng(seed)
    x = _randn(rng, (rows, D), dtype, cuda)
    w = _randn(rng, (D,), dtype, cuda)
    g = _randn(rng, (rows, D), dtype, cuda)
    rstd = torch.empty(rows, dtype=torch.float32, device=cuda)
    rms_norm_2d(x, w, rstd=rstd)
    before = rms_norm_2d_bwd.launches
    dx, dw = rms_norm_2d_bwd(g, x, w, rstd)
    torch.cuda.synchronize()
    assert rms_norm_2d_bwd.launches == before + 1
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    rms_norm_ref(xr, wr).backward(g)
    _close_grad(dx, xr.grad, GRAD_TOL[dtype])
    _close_grad(dw, wr.grad, GRAD_TOL[dtype])
    dx2, dw2 = rms_norm_2d_bwd(g, x, w, rstd)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


def _flash_grads(fn, q, k, v, do, kw):
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    fn(qs, ks, vs, **kw).backward(do)
    return qs.grad, ks.grad, vs.grad


@pytest.mark.parametrize("S,H,K,hd", [(128, 32, 8, 128), (300, 4, 2, 64),
                                      (100, 4, 4, 32), (17, 2, 1, 16)])
@pytest.mark.parametrize("causal,window,softcap",
                         [(True, 0, 0.0), (True, 64, 0.0), (True, 0, 30.0),
                          (False, 0, 0.0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_backward_matches_autograd(cuda, S, H, K, hd, causal, window,
                                         softcap, dtype):
    rng = np.random.default_rng(6)
    q = _randn(rng, (2, S, H, hd), dtype, cuda)
    k = _randn(rng, (2, S, K, hd), dtype, cuda)
    v = _randn(rng, (2, S, K, hd), dtype, cuda)
    do = _randn(rng, (2, S, H, hd), dtype, cuda)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = flash_attention_bshd(q, k, v, lse=True, **kw)
    before = flash_attention_bshd_bwd.launches
    dq, dk, dv = flash_attention_bshd_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bshd_bwd.launches == before + 1
    want = _flash_grads(flash_attention_ref, q, k, v, do, kw)
    for got, ref in zip((dq, dk, dv), want):
        _close_grad(got, ref, GRAD_TOL[dtype])
    again = flash_attention_bshd_bwd(q, k, v, o, do, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))


def test_flash_lse_is_the_rows_logsumexp(cuda):
    rng = np.random.default_rng(8)
    q, k, v = (_randn(rng, (1, 200, n, 64), torch.float32, cuda)
               for n in (4, 2, 2))
    _, lse = flash_attention_bshd(q, k, v, lse=True, softcap=20.0)
    qq = q.transpose(1, 2) * 64 ** -0.5
    kk = k.transpose(1, 2).repeat_interleave(2, dim=1)
    s = torch.tanh(qq @ kk.transpose(-1, -2) / 20.0) * 20.0
    mask = torch.ones(200, 200, dtype=torch.bool, device=cuda).tril()
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_autograd_functions_route_to_the_kernels(cuda, dtype):
    """With grad enabled the public entries run the forward kernels inside
    autograd Functions whose backward is the backward kernel."""
    rng = np.random.default_rng(9)
    x = _randn(rng, (2, 64, 128), dtype, cuda).requires_grad_()
    w = _randn(rng, (128,), dtype, cuda).requires_grad_()
    counts = (rms_norm_2d.launches, rms_norm_2d_bwd.launches)
    rms_norm(x, w).sum().backward()
    assert (rms_norm_2d.launches, rms_norm_2d_bwd.launches) == \
        (counts[0] + 1, counts[1] + 1)
    q = _randn(rng, (2, 64, 4, 32), dtype, cuda).requires_grad_()
    kv = _randn(rng, (2, 64, 2, 32), dtype, cuda).requires_grad_()
    counts = (flash_attention_bshd.launches,
              flash_attention_bshd_bwd.launches)
    flash_attention(q, kv, kv).float().square().sum().backward()
    assert (flash_attention_bshd.launches,
            flash_attention_bshd_bwd.launches) == \
        (counts[0] + 1, counts[1] + 1)
    assert q.grad is not None and kv.grad is not None
