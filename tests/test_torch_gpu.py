"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need a CUDA device and skip without one (the ``gpu`` marker); on
the GPU machine::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

The file imports no JAX: the GPU machine has none.  Tolerances are those
of tests/test_kernels.py, 2e-5 in float32 and 2e-2 in bfloat16, with the
same inputs handed to the kernel and to its plain version on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_bshd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention.kernel import paged_attention_rhd
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.rmsnorm.kernel import rms_norm_2d
from repro_torch.kernels.rmsnorm.ref import rms_norm_ref

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
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
