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
gradients where the kernels keep float32.  The checkpoint codec and the
block hash are held byte for byte; the ABFT matmul, on either route
(exact bf16 pieces on the tensor cores, or true float32 on the CUDA
cores), to 32 float32 ulps of each element's absolute mass against its
float32 plain version, bit-equal from call to call.  The selective scan is held to its
plain version within 1e-5 + 1e-5 |want| (tests/test_kernels.py) on each
route (16-byte and 4-byte copies, with the route's counter) around its
ring's tile, and bit for bit across the routes, on a repeated call and
across a scan split in two through h_last; the tiny Mamba engine on the
card gives the CPU's greedy streams.  The scan's backward kernel is held
to the plain reverse scan (``ref.selective_scan_bwd_ref``) within 1e-4
of each gradient's largest magnitude, around its 8-step tiles, ragged
Di and N, B and C read in place, on each route (TMA and 4-byte copies,
with the route's counter), bit for bit on a repeated call and across
the routes; tiny falcon-mamba trains on the card as on the CPU.  Paged
decode attention is also held bit for bit across the table's width, the
batch, the row index, the page ids and NaN in every dead position, and
the RMSNorm forward's first rows across row counts.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.abft_matmul import kernel as abft_kernel
from repro_torch.kernels.abft_matmul.kernel import abft_matmul_ext
from repro_torch.kernels.abft_matmul.ops import abft_dot, abft_matmul
from repro_torch.kernels.abft_matmul.ref import (abft_matmul_ref, checksums,
                                                 encode_ref, product_mass)
from repro_torch.kernels.block_hash.kernel import hash_leaves
from repro_torch.kernels.block_hash.ref import block_hashes_ref
from repro_torch.kernels.ckpt_codec.kernel import (dequantize_blocks,
                                                   quantize_blocks)
from repro_torch.kernels.ckpt_codec.ref import dequantize_ref, quantize_ref
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bshd, flash_attention_bshd_bwd)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention.kernel import paged_attention_rhd
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_attention_split_ref, split_positions)
from repro_torch.kernels.rmsnorm.kernel import rms_norm_2d, rms_norm_2d_bwd
from repro_torch.kernels.rmsnorm.ops import rms_norm
from repro_torch.kernels.rmsnorm.ref import rms_norm_ref
from repro_torch.kernels.selective_scan import kernel as scan_kernel
from repro_torch.kernels.selective_scan.kernel import (
    selective_scan_bwd_kernel, selective_scan_kernel)
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.selective_scan.ref import (TILE as SCAN_TILE,
                                                    selective_scan_bwd_ref,
                                                    selective_scan_ref)

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


def _split_case(rng, lengths, K, G, hd, ps, mpr, dtype, device):
    """Rows of the given lengths, each mapping ``mpr`` distinct live pages
    (no null page in a table unless a row is inactive: length 0 and a
    zeroed table)."""
    R = len(lengths)
    P = R * mpr + 1
    table = rng.permutation(np.arange(1, P))[:R * mpr].reshape(R, mpr)
    table = table.astype(np.int32)
    for r, n in enumerate(lengths):
        if n == 0:
            table[r] = 0
    q = _randn(rng, (R, K * G, hd), dtype, device)
    kp = _randn(rng, (P, ps, K, hd), dtype, device)
    vp = _randn(rng, (P, ps, K, hd), dtype, device)
    return (q, kp, vp, torch.from_numpy(table).to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device))


@pytest.mark.parametrize("G,hd", [(1, 64), (4, 128), (8, 128), (8, 64)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (0, 30.0),
                                            (40, 0.0), (70, 30.0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_split_edges_match_plain(cuda, G, hd, window, softcap, dtype):
    """Lengths at the split edges (C - 1, C, C + 1, 2 C), an inactive
    row, a full table; window 40 crosses a split boundary, window 70
    leaves whole splits out of a long row."""
    C = split_positions(hd, dtype)
    ps, mpr = 16, 20
    lengths = [0, C - 1, C, C + 1, 2 * C, 2 * C + 5, mpr * ps - 1]
    rng = np.random.default_rng(20)
    q, kp, vp, table, lens = _split_case(rng, lengths, 2, G, hd, ps, mpr,
                                         dtype, cuda)
    kw = dict(window=window, softcap=softcap)
    o = paged_attention_rhd(q, kp, vp, table, lens, **kw)
    torch.cuda.synchronize()
    want = paged_attention_ref(q[:, None], kp, vp, table, lens, **kw)[:, 0]
    _close(o, want, TOL[dtype])
    model = paged_attention_split_ref(q[:, None], kp, vp, table, lens,
                                      **kw)[:, 0]
    _close(o, model, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 64])
def test_paged_row_bits_do_not_depend_on_table_or_batch(cuda, dtype,
                                                        window):
    """Token-identical failover: a row's bits stay the same when the table
    grows (MPR 18 -> 24, 40), when R shrinks (8 -> each row alone), when
    the row moves to another index and when its pages move to other
    physical ids."""
    rng = np.random.default_rng(21)
    lengths = [0, 15, 16, 100, 200, 255, 287, 17]
    q, kp, vp, table, lens = _split_case(rng, lengths, 8, 4, 128, 16, 18,
                                         dtype, cuda)
    kw = dict(window=window)
    o = paged_attention_rhd(q, kp, vp, table, lens, **kw)
    for mpr in (24, 40):
        wide = torch.zeros(8, mpr, dtype=torch.int32, device=cuda)
        wide[:, :18] = table
        assert torch.equal(paged_attention_rhd(q, kp, vp, wide, lens, **kw),
                           o), mpr
    for r in range(8):
        one = paged_attention_rhd(q[r:r + 1].contiguous(), kp, vp,
                                  table[r:r + 1].contiguous(),
                                  lens[r:r + 1].contiguous(), **kw)
        assert torch.equal(one[0], o[r]), r
    # row 6 to index 2 of a 3-row batch, its pages to fresh ids
    P = kp.shape[0]
    fresh = torch.arange(P, P + 18, dtype=torch.int32, device=cuda)
    kp2 = torch.cat([kp, kp[table[6].long()]])
    vp2 = torch.cat([vp, vp[table[6].long()]])
    table2 = torch.stack([table[1], table[3], fresh])
    q2 = torch.stack([q[1], q[3], q[6]])
    lens2 = torch.stack([lens[1], lens[3], lens[6]])
    o2 = paged_attention_rhd(q2, kp2, vp2, table2, lens2, **kw)
    assert torch.equal(o2[2], o[6])
    assert torch.equal(paged_attention_rhd(q, kp, vp, table, lens, **kw), o)


@pytest.mark.parametrize("window", [0, 40])
def test_paged_dead_positions_change_nothing(cuda, window):
    """Every pool position that no row attends (past a length, before a
    window's start, pages no table maps) set to NaN: the output's bits do
    not move, so no dead position is read or reaches a sum."""
    rng = np.random.default_rng(22)
    lengths = [0, 63, 64, 65, 200, 287]
    ps = 16
    q, kp, vp, table, lens = _split_case(rng, lengths, 2, 4, 128, ps, 18,
                                         torch.bfloat16, cuda)
    o = paged_attention_rhd(q, kp, vp, table, lens, window=window)
    live = torch.zeros(kp.shape[:2], dtype=torch.bool, device=cuda)
    for r, n in enumerate(lengths):
        lo = max(0, n - window + 1) if window else 0
        for pos in range(lo, n + 1):
            live[table[r, pos // ps].long(), pos % ps] = True
    kn, vn = kp.clone(), vp.clone()
    kn[~live] = float("nan")
    vn[~live] = float("nan")
    o2 = paged_attention_rhd(q, kn, vn, table, lens, window=window)
    assert torch.isfinite(o2.float()).all()
    assert torch.equal(o2, o)


def test_paged_one_counted_launch_runs_both_kernels(cuda):
    rng = np.random.default_rng(23)
    q, kp, vp, table, lens = _split_case(rng, [5, 100, 287], 8, 4, 128, 16,
                                         18, torch.bfloat16, cuda)
    before = paged_attention_rhd.launches
    names = _kernel_names(lambda: paged_attention_rhd(q, kp, vp, table,
                                                      lens))
    assert paged_attention_rhd.launches == before + NAME_WARMUP + NAME_CALLS
    assert any("paged_split_kernel" in n for n in names), names
    assert any("paged_combine_kernel" in n for n in names), names
    assert len(names) == 2, names


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [4096, 100])
def test_rmsnorm_rows_do_not_depend_on_the_row_count(cuda, dtype, D):
    """Rows 0-7 of a 288- and a 4096-row call are the 8-row call's bits
    (the reduction order depends on D alone), with and without rstd."""
    rng = np.random.default_rng(24)
    x = _randn(rng, (4096, D), dtype, cuda)
    w = _randn(rng, (D,), dtype, cuda)
    rstd8 = torch.empty(8, dtype=torch.float32, device=cuda)
    y8 = rms_norm_2d(x[:8].contiguous(), w, rstd=rstd8)
    for rows in (288, 4096):
        rstd = torch.empty(rows, dtype=torch.float32, device=cuda)
        y = rms_norm_2d(x[:rows].contiguous(), w, rstd=rstd)
        assert torch.equal(y[:8], y8), rows
        assert torch.equal(rstd[:8], rstd8), rows
        assert torch.equal(rms_norm_2d(x[:rows].contiguous(), w)[:8], y8)


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


def _row_case(rng, B, sc, cache_len, K, G, hd, dtype, device):
    """Contiguous cache rows of ``sc`` slots, each row at its own query
    position (``cur``, up to ``cache_len - 1``; a rolling row past ``sc``
    holds its last ``sc`` positions at slot t mod sc), as the decode
    leaves them."""
    cur = np.linspace(0, cache_len - 1, B).astype(np.int64)
    pos = np.full((B, sc), -1, np.int32)
    for r in range(B):
        for t in range(max(0, cur[r] - sc + 1), cur[r] + 1):
            pos[r, t % sc] = t
    q = _randn(rng, (B, 1, K * G, hd), dtype, device)
    k = _randn(rng, (B, sc, K, hd), dtype, device)
    v = _randn(rng, (B, sc, K, hd), dtype, device)
    return (q, k, v, torch.from_numpy(pos).to(device),
            torch.from_numpy(cur.astype(np.int32)).to(device))


def _rows_as_pages(rng, k_rows, v_rows, pos, cur, cache_len, ps):
    """The same rows scattered into a real pool of ``ps``-token pages on
    shuffled physical pages (position t of row r on page table[r, t // ps]),
    with noise wherever a row holds no position."""
    B, sc, K, hd = k_rows.shape
    mpr = -(-cache_len // ps)
    table = rng.permutation(np.arange(1, B * mpr + 1)).reshape(B, mpr)
    kp, vp = (_randn(rng, (B * mpr + 1, ps, K, hd), k_rows.dtype,
                     k_rows.device) for _ in range(2))
    pos_h, cur_h = pos.cpu().numpy(), cur.cpu().numpy()
    for r in range(B):
        for t in range(cur_h[r] + 1):
            if pos_h[r, t % sc] == t:
                kp[table[r, t // ps], t % ps] = k_rows[r, t % sc]
                vp[table[r, t // ps], t % ps] = v_rows[r, t % sc]
    return kp, vp, torch.from_numpy(table.astype(np.int32)).to(k_rows.device)


@pytest.mark.parametrize("arch", ["granite-3-8b", "gemma2-27b"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_row_decode_view_matches_pages_and_plain(cuda, arch, dtype):
    """Decode over contiguous rows runs the paged kernel through a view
    of the rows as pages: bit-equal to the kernel over the same k/v
    scattered into real pages, within tolerance of ``decode_mha``.  Tiny
    granite's rows are full length (an identity table); tiny gemma2's
    LOCAL rows roll over its window of 8 (a wrapping table)."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention, row_decode_attention, row_page_table)
    from repro_torch.layers.attention import decode_mha
    from repro_torch.models import get_config

    cfg = get_config(arch, tiny=True)
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    G = cfg.num_heads // K
    cache_len = 48
    window = cfg.window if cfg.window else 0
    sc = window if window else cache_len
    kw = dict(window=window, softcap=cfg.attn_softcap)
    rng = np.random.default_rng(11)
    q, k, v, pos, cur = _row_case(rng, 6, sc, cache_len, K, G, hd, dtype,
                                  cuda)
    ps, table = row_page_table(6, sc, cache_len, cuda)
    assert sc % ps == 0 and table.shape == (6, -(-cache_len // ps))
    if sc == cache_len:
        assert torch.equal(table - table[:, :1],
                           torch.arange(cache_len // ps, device=cuda,
                                        dtype=torch.int32).expand(6, -1))
    before = paged_attention_rhd.launches
    got = row_decode_attention(q, k, v, pos, cur, cache_len=cache_len, **kw)
    torch.cuda.synchronize()
    assert paged_attention_rhd.launches == before + 1
    kp, vp, tbl = _rows_as_pages(rng, k, v, pos, cur, cache_len, 4)
    want = paged_decode_attention(q, kp, vp, tbl, cur, **kw)
    assert torch.equal(got, want)
    _close(got, decode_mha(q, k, v, pos, cur, **kw), TOL[dtype])
    # an idle row past cache_len reads a clamped length and leaves the
    # other rows' bits alone
    idle = cur.clone()
    idle[0] = cache_len + 5
    again = row_decode_attention(q, k, v, pos, idle, cache_len=cache_len,
                                 **kw)
    torch.cuda.synchronize()
    assert torch.equal(again[1:], got[1:])
    assert torch.isfinite(again.float()).all()


def test_tiny_bf16_slot_streams_equal_paged_streams(cuda):
    """The serving determinism contract on the card: tiny bf16 granite
    from the slot pool gives the paged pool's greedy streams (equal
    decode shapes, one prefill shape), and its decode launches the paged
    kernel a layer a step."""
    from repro_torch.models import get_config, init_params
    from repro_torch.serve import ServeEngine

    cfg = get_config("granite-3-8b", tiny=True)
    params = init_params(cfg, seed=0, device=cuda)
    prompts = [[5, 9, 2, 77, 3, 1, 8, 100], [5, 9, 2, 77, 60],
               [5, 9, 2, 77, 3, 1, 8, 100], list(range(20, 33)),
               [200, 3], list(range(40, 61))]
    streams = []
    for paged in (True, False):
        eng = ServeEngine(cfg, params, device=cuda, slots_per_replica=4,
                          max_len=40, paged=paged)
        before = paged_attention_rhd.launches
        rids = [eng.submit(p, 8) for p in prompts]
        out = eng.run()
        steps = sum(r.steps for r in eng.router.replicas.values())
        eng.shutdown()
        assert paged_attention_rhd.launches - before == \
            cfg.num_layers * steps
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


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_backward_dw_follows_row_groups(cuda, dtype):
    """dw sums fixed groups of rows, whatever the card: zero gradients
    past a group boundary leave dw (and every dx row before it) the same
    bits as the rows before the boundary alone."""
    rng = np.random.default_rng(9)
    R, cut, D = 300, 256, 4096
    x = _randn(rng, (R, D), dtype, cuda)
    w = _randn(rng, (D,), dtype, cuda)
    g = _randn(rng, (R, D), dtype, cuda)
    g[cut:] = 0
    rstd = torch.empty(R, dtype=torch.float32, device=cuda)
    rms_norm_2d(x, w, rstd=rstd)
    dx, dw = rms_norm_2d_bwd(g, x, w, rstd)
    dx_cut, dw_cut = rms_norm_2d_bwd(g[:cut].contiguous(),
                                     x[:cut].contiguous(), w,
                                     rstd[:cut].contiguous())
    assert torch.equal(dw, dw_cut)
    assert torch.equal(dx[:cut], dx_cut)


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


# the bf16 kernels' tile edges: 128-row q and kv tiles (forward, dQ pass),
# 128-row k tiles over 64-row q tiles (dK/dV pass); S at, short of and
# just past them, at the train path's heads and at two other head dims
FLASH_EDGES = [(2, S, 32, 8, 128) for S in (2048, 1500, 129, 255)] + [
    (2, 300, 4, 2, 64), (2, 300, 4, 2, 16)]


def _lse_plain(q, k, *, causal, window, softcap):
    """Each row's log-sum-exp of its float32 scores, masked."""
    S, H, hd = q.shape[1:]
    kk = k.float().repeat_interleave(H // k.shape[2], dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float(), kk) * hd ** -0.5
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    i = torch.arange(S, device=q.device)
    ok = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        ok &= i[None, :] <= i[:, None]
    if window:
        ok &= i[:, None] - i[None, :] < window
    return torch.logsumexp(s.masked_fill(~ok, float("-inf")), dim=-1)


@pytest.mark.parametrize("B,S,H,K,hd", FLASH_EDGES)
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (512, 0.0),
                                            (512, 30.0)])
def test_flash_bf16_tile_edges_match_plain(cuda, B, S, H, K, hd, window,
                                           softcap):
    """Forward (o and the LSE) and backward of the bf16 kernels against
    the plain version, bit-equal from call to call."""
    rng = np.random.default_rng(12)
    q, do = (_randn(rng, (B, S, H, hd), torch.bfloat16, cuda)
             for _ in range(2))
    k, v = (_randn(rng, (B, S, K, hd), torch.bfloat16, cuda)
            for _ in range(2))
    kw = dict(causal=True, window=window, softcap=softcap)
    o, lse = flash_attention_bshd(q, k, v, lse=True, **kw)
    o2, lse2 = flash_attention_bshd(q, k, v, lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    _close(o, flash_attention_ref(q, k, v, **kw), TOL[torch.bfloat16])
    torch.testing.assert_close(lse, _lse_plain(q, k, **kw), atol=1e-4,
                               rtol=1e-4)
    grads = flash_attention_bshd_bwd(q, k, v, o, do, lse, **kw)
    again = flash_attention_bshd_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    want = _flash_grads(flash_attention_ref, q, k, v, do, kw)
    for got, ref in zip(grads, want):
        _close_grad(got, ref, GRAD_TOL[torch.bfloat16])


def test_flash_row_does_not_depend_on_sequence_length_at_train_shape(cuda):
    """The same at the train path's length, with the LSE, two sequences
    and the 128-row tiles of the two-warpgroup blocks."""
    rng = np.random.default_rng(13)
    q, k, v = (_randn(rng, (2, 2048, n, 128), torch.bfloat16, cuda)
               for n in (32, 8, 8))
    full, lse = flash_attention_bshd(q, k, v, lse=True)
    cut, lse_cut = flash_attention_bshd(*(t[:, :1500].contiguous()
                                          for t in (q, k, v)), lse=True)
    assert torch.equal(full[:, :1500], cut)
    assert torch.equal(lse[:, :, :1500], lse_cut)


# _kernel_names: warm-up calls before the profiler's window and calls in
# it.  Three calls of a ~9 us kernel in a cold window lost the forward's
# name twice; warm calls first and a longer window keep every name.
NAME_WARMUP, NAME_CALLS = 3, 20


def _kernel_names(fn, calls=NAME_CALLS, warmup=NAME_WARMUP):
    """Names of the CUDA kernels that ``calls`` runs of ``fn`` launch,
    after ``warmup`` runs outside the profiler's window (a set: the
    profiler may drop the first kernel of its window)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.parametrize("B,S", [(1, 288), (2, 2048)])
def test_flash_bf16_launches_the_wgmma_kernels(cuda, B, S):
    """One call, one count: the forward launches its wgmma kernel, the
    backward its prep kernel and its two wgmma passes, and nothing else
    (no mma.sync kernel is left on the bf16 path)."""
    rng = np.random.default_rng(14)
    q, do = (_randn(rng, (B, S, 32, 128), torch.bfloat16, cuda)
             for _ in range(2))
    k, v = (_randn(rng, (B, S, 8, 128), torch.bfloat16, cuda)
            for _ in range(2))
    o, lse = flash_attention_bshd(q, k, v, lse=True)
    before = (flash_attention_bshd.launches,
              flash_attention_bshd_bwd.launches)
    fwd = _kernel_names(lambda: flash_attention_bshd(q, k, v, lse=True))
    bwd = _kernel_names(lambda: flash_attention_bshd_bwd(q, k, v, o, do,
                                                         lse))
    n = NAME_WARMUP + NAME_CALLS
    assert (flash_attention_bshd.launches,
            flash_attention_bshd_bwd.launches) == (before[0] + n,
                                                   before[1] + n)
    assert len(fwd) == 1 and "flash_fwd_bf16_wgmma" in fwd.pop(), fwd
    marks = ("flash_bwd_prep", "flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma")
    assert len(bwd) == 3 and all(any(m in n for n in bwd) for m in marks), \
        bwd


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


HASH_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int8,
               torch.uint8, torch.int32, torch.int64, torch.float64,
               torch.bool]


@pytest.mark.parametrize("block", [7, 256, 65536])
@pytest.mark.parametrize("n", [1, 255, 4097, 70001])
def test_block_hash_kernel_is_bit_equal(cuda, n, block):
    """Every dtype in one grouped launch, with a transposed and an offset
    view, against the plain version on the card and on the CPU."""
    rng = np.random.default_rng(n)
    base = torch.from_numpy(rng.standard_normal(n) * 1000).to(cuda)
    leaves = [(base > 0) if dt == torch.bool else base.to(dt)
              for dt in HASH_DTYPES]
    leaves += [base.reshape(-1, 1).expand(-1, 2).t(), base[1:]]
    before = hash_leaves.launches
    h, spans = hash_leaves(leaves, block)
    assert hash_leaves.launches == before + 1
    for x, (start, count) in zip(leaves, spans):
        want = block_hashes_ref(x, block)
        assert torch.equal(h[start:start + count], want), (x.dtype, block)
        assert torch.equal(want.cpu(), block_hashes_ref(x.cpu(), block))


def test_block_hash_many_leaves_take_several_launches(cuda):
    """More leaves than one launch's table holds: one launch per 120,
    every leaf bit-equal; checksums on the card equal the CPU's."""
    from repro_torch.sdc import checksums

    rng = np.random.default_rng(7)
    leaves = [_randn(rng, (int(n),), torch.float32, cuda)
              for n in rng.integers(1, 3000, 250)]
    before = hash_leaves.launches
    h, spans = hash_leaves(leaves, 256)
    assert hash_leaves.launches == before + 3
    for x, (start, count) in zip(leaves, spans):
        assert torch.equal(h[start:start + count], block_hashes_ref(x, 256))
    assert checksums(leaves) == checksums([x.cpu() for x in leaves])


def test_scrubber_on_the_card_names_a_flipped_leaf(cuda):
    from repro_torch.core import FaultInjector
    from repro_torch.sdc import StateScrubber

    rng = np.random.default_rng(1)
    state = {"a": _randn(rng, (300, 70), torch.float32, cuda),
             "b": {"c": _randn(rng, (5000,), torch.bfloat16, cuda)},
             "step": torch.zeros((), dtype=torch.int32, device=cuda)}
    scrub = StateScrubber(fraction=1.0)
    scrub.record(state, 1)
    assert scrub.verify(state) == []
    inj = FaultInjector()
    inj.schedule_bitflip(2, "b.c", 1234)
    bad = inj.apply_sdc(2, state)
    assert bad["b"]["c"].device == state["b"]["c"].device
    assert scrub.verify(bad) == ["b.c"]


# an ABFT product element within 32 float32 ulps of its absolute mass
ABFT_TOL = 32 * 2.0 ** -24


def _of_mass(got, want, a, b):
    return ((got - want).abs() / product_mass(a, b)).max().item()


@pytest.mark.parametrize("M,K,N", [(5, 7, 3), (130, 200, 72),
                                   (257, 129, 300)])
@pytest.mark.parametrize("a_dtype,b_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("a_t,b_t", [(False, False), (True, True)])
def test_abft_kernel_matches_plain(cuda, M, K, N, a_dtype, b_dtype, a_t,
                                   b_t):
    rng = np.random.default_rng(M + K + N)
    a = _randn(rng, (K, M) if a_t else (M, K), a_dtype, cuda)
    b = _randn(rng, (N, K) if b_t else (K, N), b_dtype, cuda)
    a, b = (a.t() if a_t else a), (b.t() if b_t else b)   # in-place views
    a_sum, b_sum = checksums(a, b)
    c = abft_matmul_ext(a, a_sum, b, b_sum)
    assert _of_mass(c, abft_matmul_ref(a, b), a, b) <= ABFT_TOL
    assert torch.equal(c, abft_matmul_ext(a, a_sum, b, b_sum))


def _tma_operand(rng, shape, dtype, device, transposed):
    """A (rows, cols) operand in storage TMA reads in place: rows start
    16-byte aligned, a multiple of 8 elements apart (a transposed view
    stays column-major)."""
    rows, cols = shape[::-1] if transposed else shape
    base = torch.zeros(rows, -(-cols // 8) * 8, dtype=dtype, device=device)
    base[:, :cols] = _randn(rng, (rows, cols), dtype, device)
    view = base[:, :cols]
    return view.t() if transposed else view


F32, BF16 = torch.float32, torch.bfloat16
ROUTES = ([("sgemm", a, b) for a, b in ((F32, F32), (BF16, BF16),
                                        (F32, BF16), (BF16, F32))]
          + [("tensor cores", a, b) for a, b in ((BF16, BF16), (F32, BF16),
                                                 (BF16, F32))])


def _abft_route_case(cuda, route, M, K, N, a_dtype, b_dtype, a_t, b_t,
                     seed):
    rng = np.random.default_rng(seed)
    tc = route == "tensor cores"
    if tc:
        a = _tma_operand(rng, (M, K), a_dtype, cuda, a_t)
        b = _tma_operand(rng, (K, N), b_dtype, cuda, b_t)
        assert abft_kernel.tc_route(a, b)
    else:
        a = _randn(rng, (K, M) if a_t else (M, K), a_dtype, cuda)
        b = _randn(rng, (N, K) if b_t else (K, N), b_dtype, cuda)
        a, b = (a.t() if a_t else a), (b.t() if b_t else b)
    a_sum, b_sum = checksums(a, b)
    c = abft_kernel._launch(a, a_sum, b, b_sum, route=tc)
    assert _of_mass(c, abft_matmul_ref(a, b), a, b) <= ABFT_TOL
    assert torch.equal(c, abft_kernel._launch(a, a_sum, b, b_sum, route=tc))


@pytest.mark.parametrize("M,K,N", [(5, 7, 3), (130, 200, 72),
                                   (257, 129, 300)])
@pytest.mark.parametrize("route,a_dtype,b_dtype", ROUTES)
@pytest.mark.parametrize("a_t,b_t", [(False, False), (True, True)])
def test_abft_routes_match_plain(cuda, route, M, K, N, a_dtype, b_dtype,
                                 a_t, b_t):
    """Each route at the card tests' shapes, dtypes and transposes (the
    tensor cores on operands stored for TMA), within ABFT_TOL of mass of
    the plain version, two launches bit-equal."""
    _abft_route_case(cuda, route, M, K, N, a_dtype, b_dtype, a_t, b_t,
                     M + K + N)


@pytest.mark.parametrize("M,K,N", [(64, 16, 127), (63, 17, 129),
                                   (65, 15, 255), (128, 33, 257),
                                   (127, 47, 383), (129, 65, 385)])
@pytest.mark.parametrize("a_dtype,b_dtype", [(BF16, BF16), (F32, BF16),
                                             (BF16, F32)])
@pytest.mark.parametrize("a_t,b_t", [(False, False), (True, True),
                                     (False, True)])
def test_abft_tensor_cores_at_tile_edges(cuda, M, K, N, a_dtype, b_dtype,
                                         a_t, b_t):
    """The tensor-core route where its tiles end: M at 64 k and 64 k ± 1
    (a consumer warpgroup's rows), N at 128 k ± 1, K at 16 k ± 1 (one
    wgmma step), so the checksum rows and columns land at every offset of
    a tile."""
    _abft_route_case(cuda, "tensor cores", M, K, N, a_dtype, b_dtype, a_t,
                     b_t, 7 * M + K + N)


def test_abft_dot_takes_the_tensor_core_route(cuda):
    """abft_dot's three products on bf16 operands (forward, dx with a
    float32 gradient, dw through x's transposed view) all take the
    tensor-core route."""
    rng = np.random.default_rng(5)
    x = _randn(rng, (2, 64, 128), torch.bfloat16, cuda).requires_grad_()
    w = _randn(rng, (128, 96), torch.bfloat16, cuda).requires_grad_()
    before = abft_matmul_ext.launches, abft_matmul_ext.tc_launches
    abft_dot(x, w).float().square().sum().backward()
    assert (abft_matmul_ext.launches, abft_matmul_ext.tc_launches) == (
        before[0] + 3, before[1] + 3)


def test_abft_check_rejects_a_tf32_product(cuda):
    """The bound above holds float32 accuracy: a TF32 product of the
    same extended operands falls outside it."""
    rng = np.random.default_rng(4)
    a = _randn(rng, (257, 1024), torch.float32, cuda)
    b = _randn(rng, (1024, 300), torch.float32, cuda)
    a_ext, b_ext = encode_ref(a, b)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = a_ext @ b_ext
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert _of_mass(tf32, abft_matmul_ref(a, b), a, b) > ABFT_TOL


def test_abft_on_the_card_corrects_a_single_error(cuda):
    rng = np.random.default_rng(2)
    a = _randn(rng, (200, 300), torch.float32, cuda)
    b = _randn(rng, (300, 150), torch.float32, cuda)
    clean, rep = abft_matmul(a, b)
    assert not bool(rep["detected"])
    c, rep = abft_matmul(a, b, inject=(17, 99, 40.0))
    assert bool(rep["detected"]) and bool(rep["corrected"])
    assert (int(rep["row"]), int(rep["col"])) == (17, 99)
    _close_grad(c, clean, 1e-5)
    c, rep = abft_matmul(a, b, inject=(200, 3, 40.0))     # checksum row
    assert bool(rep["corrected"]) and torch.equal(c, clean)


def test_abft_dot_routes_both_contractions_to_the_kernel(cuda):
    rng = np.random.default_rng(3)
    x = _randn(rng, (2, 64, 128), torch.bfloat16, cuda).requires_grad_()
    w = _randn(rng, (128, 96), torch.bfloat16, cuda).requires_grad_()
    before = abft_matmul_ext.launches
    y = abft_dot(x, w)
    y.float().square().sum().backward()
    assert abft_matmul_ext.launches == before + 3
    xf, wf = (t.detach().float().requires_grad_() for t in (x, w))
    (xf @ wf).square().sum().backward()
    _close_grad(x.grad, xf.grad, 2e-2)
    _close_grad(w.grad, wf.grad, 2e-2)


def _scan_inputs(rng, B, S, Di, N, device, h0_zero=False):
    """tests/test_kernels.py's draws, from numpy."""
    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)

    x = randn(B, S, Di)
    dt = torch.nn.functional.softplus(randn(B, S, Di)) * 0.1
    bm, cm = randn(B, S, N), randn(B, S, N)
    a = -torch.exp(randn(Di, N) * 0.2)
    h0 = randn(B, Di, N) * 0.1
    return x, dt, bm, cm, a, (torch.zeros_like(h0) if h0_zero else h0)


@pytest.mark.parametrize("B,S,Di,N,h0_zero", [
    (1, 256, 8192, 16, True), (1, 256, 8192, 16, False),
    (2, 200, 256, 16, False), (1, 300, 128, 4, False),
    (2, 1, 64, 16, False), (1, 77, 100, 8, False), (3, 65, 33, 5, False)])
def test_selective_scan_kernel_matches_plain(cuda, B, S, Di, N, h0_zero):
    rng = np.random.default_rng(5)
    args = _scan_inputs(rng, B, S, Di, N, cuda, h0_zero)
    before = selective_scan_kernel.launches
    y, h = selective_scan_kernel(*args)
    torch.cuda.synchronize()
    assert selective_scan_kernel.launches == before + 1
    yr, hr = selective_scan_ref(*args)
    torch.testing.assert_close(y, yr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, hr, atol=1e-5, rtol=1e-5)


def test_selective_scan_reads_b_and_c_in_place(cuda):
    """B and C as column slices of one (B, S, dtr + 2N) tensor, as the
    Mamba layer hands them over, read through their strides."""
    rng = np.random.default_rng(6)
    x, dt, _, _, a, h0 = _scan_inputs(rng, 2, 90, 64, 16, cuda)
    bcd = torch.from_numpy(rng.standard_normal((2, 90, 8 + 32)).astype(
        np.float32)).to(cuda)
    bm, cm = bcd[..., 8:24], bcd[..., 24:]
    y, h = selective_scan(x, dt, bm, cm, a, h0)
    yr, hr = selective_scan_ref(x, dt, bm.contiguous(), cm.contiguous(),
                                a, h0)
    torch.testing.assert_close(y, yr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, hr, atol=1e-5, rtol=1e-5)


def test_selective_scan_refuses_what_it_cannot_take(cuda):
    rng = np.random.default_rng(7)
    args = _scan_inputs(rng, 1, 8, 32, 17, cuda)
    with pytest.raises(ValueError, match="ssm_state up to 16"):
        selective_scan_kernel(*args)
    x, dt, bm, cm, a, h0 = _scan_inputs(rng, 1, 8, 32, 4, cuda)
    with pytest.raises(TypeError, match="float32"):
        selective_scan_kernel(x.bfloat16(), dt, bm, cm, a, h0)


def _scan_bc(rng, B, S, Di, N, device, b_at, c_at, width):
    """x, dt, A, h0 as _scan_inputs draws them; B and C as column slices
    of one (B, S, width) tensor starting at columns ``b_at`` and
    ``c_at``."""
    x, dt, _, _, a, h0 = _scan_inputs(rng, B, S, Di, N, device)
    bcd = torch.from_numpy(rng.standard_normal((B, S, width)).astype(
        np.float32)).to(device)
    return (x, dt, bcd[..., b_at:b_at + N], bcd[..., c_at:c_at + N], a, h0)


def _scan_counts():
    return (selective_scan_kernel.launches,
            selective_scan_kernel.tma_launches)


@pytest.mark.parametrize("S", [1, SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1,
                               2 * SCAN_TILE + 1, 300])
@pytest.mark.parametrize("N", [1, 3, 8, 15, 16])
def test_selective_scan_routes_at_tile_edges(cuda, S, N):
    """S around the ring's tile, Di 100 (not a multiple of the block's 32
    channels), N 1-16, B 1-3: the TMA route (its counter shows it ran)
    within 1e-5 of the plain version, and the 4-byte-copy route forced on
    the same operands gives the same bits."""
    B = 1 + S % 3
    rng = np.random.default_rng(S * 17 + N)
    args = _scan_bc(rng, B, S, 100, N, cuda, b_at=0, c_at=16, width=32)
    assert scan_kernel.tma_route(*args[:4])
    before = _scan_counts()
    y, h = selective_scan_kernel(*args)
    torch.cuda.synchronize()
    assert _scan_counts() == (before[0] + 1, before[1] + 1)
    yr, hr = selective_scan_ref(*args)
    torch.testing.assert_close(y, yr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, hr, atol=1e-5, rtol=1e-5)
    y4, h4 = scan_kernel._launch(*args, tma=False)
    assert torch.equal(y4, y) and torch.equal(h4, h)
    assert _scan_counts() == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("B,S,Di,N,b_at,c_at,width", [
    (1, 256, 99, 16, 0, 16, 32), (3, 65, 33, 5, 0, 5, 10),
    (2, 90, 64, 16, 3, 19, 40), (2, 33, 128, 16, 8, 24, 42),
    (1, 300, 4, 3, 1, 4, 7)])
def test_selective_scan_narrow_route_matches_plain(cuda, B, S, Di, N, b_at,
                                                   c_at, width):
    """Operands TMA cannot read in place (Di not a multiple of 4, B and C
    off 16-byte alignment or at a time stride of 4 k + 2 floats) take the
    4-byte-copy route: its counter shows it, within 1e-5 of the plain
    version."""
    rng = np.random.default_rng(Di + S)
    args = _scan_bc(rng, B, S, Di, N, cuda, b_at, c_at, width)
    assert not scan_kernel.tma_route(*args[:4])
    before = _scan_counts()
    y, h = selective_scan_kernel(*args)
    torch.cuda.synchronize()
    assert _scan_counts() == (before[0] + 1, before[1])
    yr, hr = selective_scan_ref(*args)
    torch.testing.assert_close(y, yr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, hr, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,S,Di,N", [(1, 256, 8192, 16), (3, 77, 100, 15)])
def test_selective_scan_repeats_bit_for_bit(cuda, B, S, Di, N):
    rng = np.random.default_rng(B + S)
    args = _scan_inputs(rng, B, S, Di, N, cuda)
    first = selective_scan_kernel(*args)
    second = selective_scan_kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("S1", [1, SCAN_TILE - 3, SCAN_TILE, 45,
                                2 * SCAN_TILE + 1])
@pytest.mark.parametrize("tma", [True, False])
def test_selective_scan_split_is_one_scan(cuda, S1, tma):
    """S1 steps, then the rest from h_last, give the bits of one scan of
    all 200 steps: a step's arithmetic does not depend on where its tile
    starts."""
    rng = np.random.default_rng(S1)
    x, dt, bm, cm, a, h0 = _scan_inputs(rng, 2, 200, 96, 16, cuda)
    y, h = scan_kernel._launch(x, dt, bm, cm, a, h0, tma=tma)
    cut = [t[:, :S1].contiguous() for t in (x, dt, bm, cm)]
    rest = [t[:, S1:].contiguous() for t in (x, dt, bm, cm)]
    y1, h1 = scan_kernel._launch(*cut, a, h0, tma=tma)
    y2, h2 = scan_kernel._launch(*rest, a, h1, tma=tma)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(h2, h)


def test_selective_scan_refuses_a_tma_launch_it_cannot_take(cuda):
    rng = np.random.default_rng(8)
    args = _scan_inputs(rng, 1, 8, 33, 4, cuda)
    with pytest.raises(RuntimeError, match="selective_scan"):
        scan_kernel._launch(*args, tma=True)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def test_tiny_mamba_engine_on_the_card_matches_the_cpu(cuda):
    """The Mamba serving path in float32 through the slot pool: the scan
    kernel on the card, the plain versions on the CPU, the same greedy
    streams (a one-token prompt takes the single-step branch)."""
    from repro_torch.models import get_config, init_params
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("falcon-mamba-7b", tiny=True),
                              dtype=torch.float32)
    cpu = init_params(cfg, seed=0, device="cpu")
    prompts = [[5, 9, 2, 77, 3, 1, 8, 100], [5, 9, 2, 77, 60], [42],
               list(range(20, 53)), [7, 7]]
    streams = []
    for params, device in ((cpu, "cpu"), (_to(cpu, cuda), "cuda")):
        eng = ServeEngine(cfg, params, device=device, slots_per_replica=4,
                          max_len=48)
        assert not eng.paged
        before = selective_scan_kernel.launches
        rids = [eng.submit(p, 8) for p in prompts]
        out = eng.run()
        eng.shutdown()
        streams.append([out[r] for r in rids])
        if device == "cuda":
            assert (selective_scan_kernel.launches - before
                    == cfg.num_layers * sum(len(p) > 1 for p in prompts))
    assert streams[0] == streams[1]


def _scan_bwd_args(rng, B, S, Di, N, device, carried, strided=False):
    """_scan_inputs's draws, dy ~ N(0, 1) and (``carried``) a random h0
    and dh_last; ``strided``: B and C as column slices of one tensor."""
    x, dt, bm, cm, a, h0 = _scan_inputs(rng, B, S, Di, N, device,
                                        h0_zero=not carried)
    if strided:
        bcd = torch.cat([torch.zeros_like(bm[..., :3]), bm, cm], dim=-1)
        bm, cm = bcd[..., 3:3 + N], bcd[..., 3 + N:]
    dy = torch.from_numpy(rng.standard_normal((B, S, Di)).astype(
        np.float32)).to(device)
    dh = (torch.from_numpy(rng.standard_normal((B, Di, N)).astype(
        np.float32)).to(device) if carried else None)
    return (x, dt, bm, cm, a, h0, dy, dh)


@pytest.mark.parametrize("B,S,Di,N,carried,strided", [
    (2, 256, 8192, 16, False, True), (1, 200, 256, 16, True, False),
    (2, 1, 64, 16, True, False), (1, 33, 100, 4, True, True),
    (3, 65, 33, 5, False, False), (1, 95, 40, 1, True, False),
    (2, 64, 96, 8, True, True)])
def test_selective_scan_bwd_kernel_matches_plain(cuda, B, S, Di, N, carried,
                                                 strided):
    rng = np.random.default_rng(B * 1000 + S + Di + N)
    args = _scan_bwd_args(rng, B, S, Di, N, cuda, carried, strided)
    before = selective_scan_bwd_kernel.launches
    got = selective_scan_bwd_kernel(*args)
    torch.cuda.synchronize()
    assert selective_scan_bwd_kernel.launches == before + 1
    want = selective_scan_bwd_ref(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        _close_grad(g, w, 1e-4)


def test_selective_scan_bwd_repeats_bit_for_bit(cuda):
    rng = np.random.default_rng(11)
    args = _scan_bwd_args(rng, 2, 300, 512, 16, cuda, True, True)
    first = selective_scan_bwd_kernel(*args)
    second = selective_scan_bwd_kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# (B, S, Di, N, carried, strided): S around the backward's 8-step tiles
# (1, 7, 9, 65), Di off the block's 32 channels (33, 100, 4100), one, two
# and four states a thread (N 1, 4, 5, 8, 15, 16), a carried state over
# three batch rows
BWD_EDGES = [(1, 1, 64, 16, True, False), (2, 7, 96, 16, False, True),
             (3, 9, 33, 5, True, False), (3, 65, 100, 4, True, True),
             (1, 77, 4100, 15, True, True), (2, 64, 64, 1, False, False),
             (3, 40, 256, 8, True, True), (2, 130, 4096, 16, True, True)]


@pytest.mark.parametrize("B,S,Di,N,carried,strided", BWD_EDGES)
def test_selective_scan_bwd_routes_match_plain_and_each_other(
        cuda, B, S, Di, N, carried, strided):
    """Each route the operands allow (TMA boxes where Di % 4 == 0 and B,
    C are 16-byte aligned, 4-byte copies always) against the plain
    reverse scan, two launches of each bit-equal, and the routes
    bit-equal to each other; the wrapper takes the route its rule
    picks and counts it."""
    rng = np.random.default_rng(B * 7 + S * 5 + Di + N)
    args = _scan_bwd_args(rng, B, S, Di, N, cuda, carried, strided)
    want = selective_scan_bwd_ref(*args)
    tma_ok = scan_kernel.bwd_tma_route(*args[:4], args[6])
    outs = []
    for tma in ((True, False) if tma_ok else (False,)):
        got = scan_kernel._bwd_launch(*args, tma=tma)
        again = scan_kernel._bwd_launch(*args, tma=tma)
        torch.cuda.synchronize()
        assert all(torch.equal(g, h) for g, h in zip(got, again)), tma
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.is_contiguous()
            _close_grad(g, w, 1e-4)
        outs.append(got)
    if len(outs) == 2:
        assert all(torch.equal(g, h) for g, h in zip(*outs))
    before = (selective_scan_bwd_kernel.launches,
              selective_scan_bwd_kernel.tma_launches)
    got = selective_scan_bwd_kernel(*args)
    assert selective_scan_bwd_kernel.launches == before[0] + 1
    assert selective_scan_bwd_kernel.tma_launches == before[1] + int(tma_ok)
    assert all(torch.equal(g, h) for g, h in zip(got, outs[0]))


def test_selective_scan_bwd_refuses_a_tma_launch_it_cannot_take(cuda):
    rng = np.random.default_rng(14)
    args = _scan_bwd_args(rng, 1, 8, 33, 4, cuda, False)
    with pytest.raises(RuntimeError, match="selective_scan_bwd"):
        scan_kernel._bwd_launch(*args, tma=True)


def test_selective_scan_bwd_refuses_what_it_cannot_take(cuda):
    rng = np.random.default_rng(12)
    x, dt, bm, cm, a, h0, dy, _ = _scan_bwd_args(rng, 1, 8, 32, 4, cuda,
                                                 False)
    with pytest.raises(ValueError, match="dy"):
        selective_scan_bwd_kernel(x, dt, bm, cm, a, h0, dy[:, :4])
    with pytest.raises(ValueError, match="dh_last"):
        selective_scan_bwd_kernel(x, dt, bm, cm, a, h0, dy, h0[:, :4])


def test_scan_gradient_on_the_card_runs_the_kernels(cuda):
    """``selective_scan`` under autograd on CUDA tensors: the forward
    kernel and the backward kernel, one launch each, the plain version's
    gradients."""
    rng = np.random.default_rng(13)
    x, dt, bm, cm, a, h0, dy, _ = _scan_bwd_args(rng, 2, 70, 64, 16, cuda,
                                                 False)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, bm, cm, a)]
    f0, b0 = selective_scan_kernel.launches, selective_scan_bwd_kernel.launches
    y, _ = selective_scan(*ins, h0)
    grads = torch.autograd.grad((y * dy).sum(), ins)
    assert selective_scan_kernel.launches == f0 + 1
    assert selective_scan_bwd_kernel.launches == b0 + 1
    want = selective_scan_bwd_ref(x, dt, bm, cm, a, h0, dy)
    for g, w in zip(grads, want[:5]):
        _close_grad(g, w, 1e-4)


def test_tiny_mamba_training_on_the_card_matches_the_cpu(cuda):
    """Tiny falcon-mamba in float32: three train steps on the card (the
    scan kernels) and on the CPU (plain versions) give the same losses
    within 1e-4, and two identical card steps the same bits."""
    from repro_torch.data import make_pipeline
    from repro_torch.models import get_config
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.step import metrics_to_host
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("falcon-mamba-7b", tiny=True),
                              dtype=torch.float32)
    step_fn = make_train_step(cfg, total_steps=3, warmup_steps=1,
                              microbatches=2)
    cpu_state = init_state(cfg, seed=0, device="cpu")
    losses = {}
    for device in ("cpu", "cuda"):
        state = _to(cpu_state, device)
        data = make_pipeline(cfg, 64, 4, seed=0)
        before = selective_scan_bwd_kernel.launches
        losses[device] = []
        for _ in range(3):
            state, m = step_fn(state, data.next_batch())
            losses[device].append(metrics_to_host(m)["loss"])
        if device == "cuda":
            assert (selective_scan_bwd_kernel.launches - before
                    == 3 * 2 * cfg.num_layers)
            batch = make_pipeline(cfg, 64, 4, seed=1).next_batch()
            s1, _ = step_fn(state, batch)
            s2, _ = step_fn(state, batch)
            for a, b in zip(leaves(s1), leaves(s2)):
                assert torch.equal(a, b)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# --------------------------------------------------------------------------
# slice 8: MoE train steps, the compressed reduction over ranks
# --------------------------------------------------------------------------

def test_mixtral_moe_steps_bit_equal_under_deterministic_algorithms(cuda):
    """Two identical MoE train steps from one state on the card give the
    same bits (deterministic algorithms: the dispatch writes each kept
    copy's slot by index, the combine's gather backward sorts); the
    kernels of the attention path launch."""
    from repro_torch.data import ShardedPipeline
    from repro_torch.models import get_config
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import flatten_named

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=1,
                              d_model=1024, num_heads=8, num_kv_heads=2,
                              head_dim=128, d_ff=2048)
    state = init_state(cfg, seed=0, device=cuda)
    batch = ShardedPipeline(cfg, 256, 4, dp_width=1).next_batch()
    step = make_train_step(cfg, total_steps=10, microbatches=2)
    flash_attention_bshd.launches = 0
    a, ma = step(state, batch)
    b, mb = step(state, batch)
    assert flash_attention_bshd.launches == 2 * 2 * 2    # fwd + recompute
    assert float(ma["aux"]) > 0 and np.isfinite(float(ma["loss"]))
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for (n, x), (_, y) in zip(flatten_named(a), flatten_named(b)):
        assert torch.equal(x, y), n


def test_compressed_psum_over_two_ranks_on_the_card(cuda, tmp_path):
    """``compressed_psum`` on 2 ranks sharing the card: each payload is
    the plain codec's bytes, the reduced value the rank-order mean of the
    dequantized payloads bit for bit on both ranks, the residual exactly
    ``g_eff - deQ(Q(g_eff))``; the codec kernels launch."""
    import torch_mesh_workers as W
    from repro_torch.sharding.launch import spawn

    rounds, n = 3, 5000
    out = spawn(W.compress_card, 2, run_dir=str(tmp_path), device="cuda",
                args=(0, rounds, n), join_timeout=300)
    for t in range(rounds):
        deq = []
        for r in out:
            rec = r["rounds"][t]
            g_eff = torch.from_numpy(rec["g"] + rec["ef"])
            q, s = quantize_ref(g_eff)
            assert np.array_equal(q.numpy(), rec["q"])
            assert np.array_equal(s.numpy(), rec["s"])
            d = dequantize_ref(q, s, (n,)).numpy()
            assert np.array_equal(rec["new_ef"], g_eff.numpy() - d)
            deq.append(d)
        want = (deq[0] + deq[1]) / 2
        for r in out:
            assert np.array_equal(r["rounds"][t]["red"], want)
    for r in out:
        # psum: a quantize and 1 + 2 dequantizes a round; the record's
        # own quantize one more
        assert r["quantize"] == 2 * rounds
        assert r["dequantize"] == 3 * rounds


def test_sharded_device_codec_restore_decodes_on_the_card(cuda, tmp_path):
    """A ``device_codec`` sharded save on a (2, 2) mesh of ranks on the
    card, restored onto (1, 2): each rank's int8 shards reach the card
    encoded and the dequantize kernel decodes them (one launch a shard
    overlapping the rank's region), with the plain codec's bits."""
    import torch_mesh_workers as W
    from repro_torch.sharding.launch import spawn

    leaves = {"big": np.linspace(-3, 3, 3 * 2048,
                                 dtype=np.float32).reshape(3, 2048),
              "w": np.arange(60, dtype=np.float32).reshape(6, 10)}
    spec_a = {"big": [None, "model"], "w": ["data", "model"]}
    spec_b = {"big": ["model", "data"], "w": [None, "model"]}
    ck = str(tmp_path / "ckpt")
    info = spawn(W.ckpt_save, 4, run_dir=str(tmp_path / "a"), device="cuda",
                 args=(ck, (2, 2), leaves, spec_a, None, False, (1,), True),
                 join_timeout=300)
    want = {k: v.copy() for k, v in leaves.items()}
    for i in info:
        sl = tuple(slice(a, b) for a, b in i["spans"]["big"])
        part = torch.from_numpy(leaves["big"][sl].copy())
        q, s = quantize_ref(part)
        want["big"][sl] = dequantize_ref(q, s, part.shape).numpy()
    shapes = {k: (list(v.shape), str(v.dtype)) for k, v in leaves.items()}
    out = spawn(W.ckpt_restore, 2, run_dir=str(tmp_path / "b"),
                device="cuda", args=(ck, (1, 2), shapes, spec_b, None, True),
                join_timeout=300)
    for r in out:
        for k, (arr, spans) in r["leaves"].items():
            sl = tuple(slice(a, b) for a, b in spans)
            assert np.array_equal(arr, want[k][sl]), k
        assert r["decodes"] == ["cuda", "cuda"]
        assert r["dequantize"] == 2


# ---------------------------------------------------------------------------
# the other model families' shapes: flash at head_dim 256 and 80, paged
# decode past G hd 1024
# ---------------------------------------------------------------------------

WIDE_FLASH = [
    # B, S, H, K, hd, causal, window, softcap
    (1, 256, 16, 16, 256, True, 0, 0.0),     # gemma-7b's prefill
    (1, 300, 16, 16, 256, True, 0, 30.0),    # ragged, softcap
    (1, 2300, 16, 1, 256, True, 2048, 0.0),  # recurrentgemma-2b, window
    (2, 130, 4, 2, 256, False, 0, 0.0),      # non-causal, ragged tail
    (4, 1000, 16, 16, 80, False, 0, 0.0),    # hubert-xlarge's encoder
    (2, 300, 4, 2, 80, True, 64, 30.0),      # ragged, window, softcap
    (1, 65, 2, 1, 80, True, 0, 0.0),         # one row past a tile
]


@pytest.mark.parametrize("B,S,H,K,hd,causal,window,softcap", WIDE_FLASH)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_wide_heads_match_plain(cuda, B, S, H, K, hd, causal, window,
                                      softcap, dtype):
    rng = np.random.default_rng(30)
    q = _randn(rng, (B, S, H, hd), dtype, cuda)
    k = _randn(rng, (B, S, K, hd), dtype, cuda)
    v = _randn(rng, (B, S, K, hd), dtype, cuda)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = flash_attention_bshd.launches
    o, lse = flash_attention_bshd(q, k, v, lse=True, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bshd.launches == before + 1
    _close(o, flash_attention_ref(q, k, v, **kw), TOL[dtype])
    from repro_torch.layers.attention import NEG_INF, _mask, _softcap
    s = torch.einsum("bshd,bthd->bhst", q.float(),
                     k.float().repeat_interleave(H // K, dim=2)) * hd ** -0.5
    pos = torch.arange(S, device=cuda)
    s = torch.where(_mask(pos, pos, causal=causal, window=window),
                    _softcap(s, softcap), NEG_INF)
    _close(lse, torch.logsumexp(s, dim=-1), 1e-4)
    assert torch.equal(flash_attention_bshd(q, k, v, **kw), o)


@pytest.mark.parametrize("hd", [256, 80])
def test_flash_wide_row_does_not_depend_on_sequence_length(cuda, hd):
    rng = np.random.default_rng(31)
    q, k, v = (_randn(rng, (1, 520, n, hd), torch.bfloat16, cuda)
               for n in (16, 1, 1))
    full = flash_attention_bshd(q, k, v, window=256)
    cut = flash_attention_bshd(*(t[:, :333].contiguous() for t in (q, k, v)),
                               window=256)
    assert torch.equal(full[:, :333], cut)


WIDE_BWD = [
    # B, S, H, K, hd, causal, window, softcap, padded q heads a kv group
    (1, 300, 16, 16, 256, True, 0, 0.0, 0),    # gemma-7b, ragged
    (1, 520, 16, 1, 256, True, 256, 0.0, 6),   # recurrentgemma-2b: MQA,
                                               # 10 of 16 heads real
    (2, 130, 4, 2, 256, False, 0, 30.0, 0),    # non-causal, softcap
    (4, 200, 4, 4, 80, False, 0, 0.0, 0),      # hubert-xlarge, ragged
    (2, 300, 4, 2, 80, True, 64, 30.0, 0),     # window, softcap
    (1, 65, 16, 1, 80, True, 0, 0.0, 4),       # MQA, padded heads, one
                                               # row past a tile
]


@pytest.mark.parametrize("B,S,H,K,hd,causal,window,softcap,pad", WIDE_BWD)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_backward_refuses_wide_heads(cuda, B, S, H, K, hd, causal,
                                           window, softcap, pad, dtype):
    """The backward at head_dim 256 and 80 (refused before they trained)
    against autograd of the plain version, through the kernel and through
    autograd; two launches bit-equal.  Padded q heads (the last ``pad`` of
    each kv group, masked in the model: their output gradient is 0) get a
    dq of exactly 0."""
    rng = np.random.default_rng(32)
    q = _randn(rng, (B, S, H, hd), dtype, cuda)
    k = _randn(rng, (B, S, K, hd), dtype, cuda)
    v = _randn(rng, (B, S, K, hd), dtype, cuda)
    do = _randn(rng, (B, S, H, hd), dtype, cuda)
    real = torch.arange(H, device=cuda) % (H // K) < H // K - pad
    do = do * real[:, None].to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = flash_attention_bshd(q, k, v, lse=True, **kw)
    before = flash_attention_bshd_bwd.launches
    grads = flash_attention_bshd_bwd(q, k, v, o, do, lse, **kw)
    again = flash_attention_bshd_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bshd_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    want = _flash_grads(flash_attention_ref, q, k, v, do, kw)
    for got, ref in zip(grads, want):
        _close_grad(got, ref, GRAD_TOL[dtype])
    if pad:
        assert not grads[0][:, :, ~real].any()
    auto = _flash_grads(flash_attention, q, k, v, do, kw)
    assert all(torch.equal(a, b) for a, b in zip(auto, grads))


BWD_MARKS = {256: ("flash_bwd_prep<256>", "flash_bwd_dkdv_wgmma<256, 256>",
                   "flash_bwd_dq_wgmma<256, 256>"),
             80: ("flash_bwd_prep<80>", "flash_bwd_dkdv_wgmma<128, 80>",
                  "flash_bwd_dq_wgmma<128, 80>")}


@pytest.mark.parametrize("hd", [256, 80])
def test_flash_wide_backward_launches_its_wgmma_kernels(cuda, hd):
    rng = np.random.default_rng(37)
    q, k, v, do = (_randn(rng, (1, 300, 4, hd), torch.bfloat16, cuda)
                   for _ in range(4))
    o, lse = flash_attention_bshd(q, k, v, lse=True)
    before = flash_attention_bshd_bwd.launches
    names = _kernel_names(lambda: flash_attention_bshd_bwd(q, k, v, o, do,
                                                           lse))
    assert (flash_attention_bshd_bwd.launches
            == before + NAME_WARMUP + NAME_CALLS)
    assert len(names) == 3, names
    assert all(any(m in n for n in names) for m in BWD_MARKS[hd]), names


@pytest.mark.parametrize("hd,mark", [(256, "flash_fwd_bf16_wgmma<256, 1, 256>"),
                                     (80, "flash_fwd_bf16_wgmma<128, 1, 80>")])
def test_flash_wide_heads_launch_their_wgmma_kernels(cuda, hd, mark):
    rng = np.random.default_rng(33)
    q, k, v = (_randn(rng, (1, 300, 4, hd), torch.bfloat16, cuda)
               for _ in range(3))
    before = flash_attention_bshd.launches
    names = _kernel_names(lambda: flash_attention_bshd(q, k, v))
    assert flash_attention_bshd.launches == before + NAME_WARMUP + NAME_CALLS
    assert len(names) == 1 and mark in names.pop()


WIDE_GROUPS = [(16, 256), (10, 256), (32, 128)]   # G hd 4096, 2560, 4096


@pytest.mark.parametrize("G,hd", WIDE_GROUPS)
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (40, 0.0),
                                            (0, 30.0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_wide_groups_match_plain(cuda, G, hd, window, softcap, dtype):
    C = split_positions(hd, dtype)
    ps, mpr = 16, 12
    lengths = [0, C - 1, C, C + 1, 2 * C + 5, mpr * ps - 1]
    rng = np.random.default_rng(34)
    q, kp, vp, table, lens = _split_case(rng, lengths, 1, G, hd, ps, mpr,
                                         dtype, cuda)
    kw = dict(window=window, softcap=softcap)
    o = paged_attention_rhd(q, kp, vp, table, lens, **kw)
    torch.cuda.synchronize()
    want = paged_attention_ref(q[:, None], kp, vp, table, lens, **kw)[:, 0]
    _close(o, want, TOL[dtype])
    model = paged_attention_split_ref(q[:, None], kp, vp, table, lens,
                                      **kw)[:, 0]
    _close(o, model, TOL[dtype])


@pytest.mark.parametrize("G,hd", [(16, 256), (10, 256)])
def test_paged_wide_group_row_bits_do_not_depend_on_placement(cuda, G, hd):
    """The split design's invariant at G hd 4096 and 2560: a row's bits
    stay the same across the table's width, R, the row's index and fresh
    page ids."""
    rng = np.random.default_rng(35)
    lengths = [0, 15, 100, 191, 17]
    q, kp, vp, table, lens = _split_case(rng, lengths, 1, G, hd, 16, 12,
                                         torch.bfloat16, cuda)
    o = paged_attention_rhd(q, kp, vp, table, lens, window=64)
    wide = torch.zeros(5, 30, dtype=torch.int32, device=cuda)
    wide[:, :12] = table
    assert torch.equal(paged_attention_rhd(q, kp, vp, wide, lens,
                                           window=64), o)
    for r in range(5):
        one = paged_attention_rhd(q[r:r + 1].contiguous(), kp, vp,
                                  table[r:r + 1].contiguous(),
                                  lens[r:r + 1].contiguous(), window=64)
        assert torch.equal(one[0], o[r]), r
    P = kp.shape[0]
    fresh = torch.arange(P, P + 12, dtype=torch.int32, device=cuda)
    kp2 = torch.cat([kp, kp[table[3].long()]])
    vp2 = torch.cat([vp, vp[table[3].long()]])
    o2 = paged_attention_rhd(torch.stack([q[1], q[3]]), kp2, vp2,
                             torch.stack([table[1], fresh]),
                             torch.stack([lens[1], lens[3]]), window=64)
    assert torch.equal(o2[1], o[3]) and torch.equal(o2[0], o[1])


def test_paged_wide_group_runs_both_kernels(cuda):
    rng = np.random.default_rng(36)
    q, kp, vp, table, lens = _split_case(rng, [5, 100, 191], 1, 16, 256, 16,
                                         12, torch.bfloat16, cuda)
    before = paged_attention_rhd.launches
    names = _kernel_names(lambda: paged_attention_rhd(q, kp, vp, table,
                                                      lens))
    assert paged_attention_rhd.launches == before + NAME_WARMUP + NAME_CALLS
    assert any("paged_split_kernel" in n for n in names), names
    assert any("paged_combine_kernel" in n for n in names), names
    assert len(names) == 2, names


# --------------------------------------------------------------------------
# the launch tooling: the kernels' meta path and one rank's step
# --------------------------------------------------------------------------

def test_kernels_meta_outputs_are_the_kernels_outputs(cuda):
    """Each kernel op on meta tensors returns what its kernel returns on
    the card: the same shapes and dtypes, forward and backward."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for dev in (cuda, torch.device("meta")):
        q = torch.randn(2, 128, 4, 64, device=cuda, generator=g,
                        dtype=torch.bfloat16).to(dev).requires_grad_(True)
        kv = torch.randn(2, 128, 2, 64, device=cuda, generator=g,
                         dtype=torch.bfloat16).to(dev).requires_grad_(True)
        o = flash_attention(q, kv, kv, causal=True)
        o.sum().backward()
        x = torch.randn(64, 256, device=cuda, generator=g).to(dev)
        w = torch.ones(256, device=cuda).to(dev)
        y = rms_norm(x.requires_grad_(True), w.requires_grad_(True))
        y.sum().backward()
        got = [(t.shape, t.dtype) for t in (o, q.grad, kv.grad, y, x.grad,
                                            w.grad)]
        if dev.type == "cuda":
            want = got
    assert got == want


def test_rank_probe_peak_is_within_the_dry_run_estimate(cuda):
    """Rank 0 of a (2, 2) description mesh, tiny granite (kv heads whole
    over tp 2 at 1 kv head), one real step on the card with the recording
    comm for its peers: its measured peak within the dry run's estimate
    (no more than 10 % below), launches on the path."""
    from repro_torch.launch.dryrun import rank_probe, trace_cell
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.launch.shapes import batch_sds, state_sds
    from repro_torch.models import get_config

    cfg = dataclasses.replace(get_config("granite-3-8b", tiny=True),
                              num_kv_heads=1, d_model=256, d_ff=512)
    mesh = make_mesh_compat((2, 2), ("data", "model"))
    state_g, st_sh = state_sds(cfg, mesh)
    batch, b_sh = batch_sds(cfg, 1024, 8, mesh, "train")
    est = trace_cell(cfg, mesh, state_g, batch, st_sh, b_sh,
                     microbatches=2)["memory"]["peak_per_device_bytes"]
    got = rank_probe(cfg, mesh, state_g, batch, st_sh, microbatches=2,
                     seed=0, device="cuda", profile=False)
    assert np.isfinite(got["loss"])
    assert est >= 0.9 * got["measured_peak_bytes"], (est, got)
    assert got["launches"]["flash_attention"] == 2 * 2 * cfg.num_layers
    assert got["launches"]["flash_attention_bwd"] == 2 * cfg.num_layers
