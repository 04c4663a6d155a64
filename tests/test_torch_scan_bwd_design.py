"""The order of operations of the port's scan-backward kernel, on the CPU.

``csrc/selective_scan_bwd.cu`` runs only on the card.  It recomputes the
states with the forward kernel's decay, sums u and sum_n q A over a
part's states and folds the parts' dx and ddt in the forward kernel's
tree, sums dB and dC over a block's 32 channels in a fixed tree and then
over the blocks in block order, and dA over time and then over the
batch rows.  ``kernels/selective_scan/ref.py`` models that order
(``selective_scan_bwd_parts_ref``); here the model is held to
``jax.vjp`` of the reference's ``models/mamba.py:_ssm_chunked`` (the
scan the reference trains through) within 2e-5 of each gradient's
largest magnitude (the tolerance of tests/test_torch_mamba_train.py),
and to the port's plain reverse scan ``selective_scan_bwd_ref`` within
the same, at one state a part (N <= 8) and two (N 16, ragged N), ragged
Di over several blocks, ragged S, a carried state and dh_last.  The
backward wrapper's route rule is checked on CPU tensors: it reads only
shapes, strides and alignment."""
import jax
import numpy as np
import pytest
import torch

from repro.models.mamba import _ssm_chunked
from repro_torch.kernels.selective_scan.kernel import bwd_tma_route
from repro_torch.kernels.selective_scan.ref import (CHANNELS, _block_sum,
                                                    part_tree_ref,
                                                    selective_scan_bwd_parts_ref,
                                                    selective_scan_bwd_ref)

TOL = 2e-5
NAMES = ("dx", "ddt", "dB", "dC", "dA", "dh0")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, Di, N, seed):
    """tests/test_kernels.py's draws, dy ~ N(0, 1) and dh_last ~ N(0, 1),
    as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, Di)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, Di)))) * 0.1
          ).astype(np.float32)
    bm = rng.standard_normal((B, S, N)).astype(np.float32)
    cm = rng.standard_normal((B, S, N)).astype(np.float32)
    a = (-np.exp(rng.standard_normal((Di, N)) * 0.2)).astype(np.float32)
    h0 = (rng.standard_normal((B, Di, N)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((B, S, Di)).astype(np.float32)
    dh = rng.standard_normal((B, Di, N)).astype(np.float32)
    return x, dt, bm, cm, a, h0, dy, dh


def _assert_grad(got, want, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= TOL * scale, (
        what, np.abs(got - want).max() / scale)


CASES = [(2, 40, 8, 4, False), (2, 33, 70, 16, True), (3, 17, 33, 5, True),
         (1, 50, 96, 15, False), (1, 1, 40, 1, True), (2, 24, 64, 8, True)]


@pytest.mark.parametrize("B,S,Di,N,carried", CASES)
def test_bwd_order_model_matches_jax_vjp(B, S, Di, N, carried):
    x, dt, bm, cm, a, h0, dy, dh = _inputs(B, S, Di, N, seed=S + Di + N)
    if not carried:
        h0, dh = np.zeros_like(h0), np.zeros_like(dh)
    _, vjp = jax.vjp(lambda dt_, x_, b_, c_, a_, h_: _ssm_chunked(
        dt_, x_, b_, c_, a_, h_), dt, x, bm, cm, a, h0)
    gdt, gx, gb, gc, ga, gh = vjp((dy, dh))
    t = [torch.from_numpy(v) for v in (x, dt, bm, cm, a, h0, dy, dh)]
    got = selective_scan_bwd_parts_ref(*t[:7], t[7] if carried else None)
    for name, g, w in zip(NAMES, got, (gx, gdt, gb, gc, ga, gh)):
        _assert_grad(g, w, f"{name} B={B} S={S} Di={Di} N={N}")


@pytest.mark.parametrize("B,S,Di,N,carried", CASES)
def test_bwd_order_model_matches_plain_reverse_scan(B, S, Di, N, carried):
    t = [torch.from_numpy(v) for v in _inputs(B, S, Di, N, seed=7 * S + N)]
    dh = t[7] if carried else None
    got = selective_scan_bwd_parts_ref(*t[:7], dh)
    want = selective_scan_bwd_ref(*t[:7], dh)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.is_contiguous(), name
        _assert_grad(g, w.numpy(), f"{name} B={B} S={S} Di={Di} N={N}")


def test_block_sum_is_a_tree_per_block_then_blocks_in_order():
    """dB's and dC's sum over channels: each block of 32 folded in the
    fixed tree (zeros past Di), the blocks' sums added in block order."""
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.standard_normal((2, 70, 3)).astype(np.float32))
    got = _block_sum(v, CHANNELS)
    pad = torch.nn.functional.pad(v, (0, 0, 0, 96 - 70))
    blocks = [part_tree_ref(pad[:, k * 32:(k + 1) * 32].transpose(1, 2))
              for k in range(3)]
    assert torch.equal(got, (blocks[0] + blocks[1]) + blocks[2])
    torch.testing.assert_close(got, v.sum(1), rtol=1e-5, atol=1e-5)


def test_bwd_route_rule_needs_dy_aligned():
    """TMA takes the backward where it takes the forward and dy starts
    16-byte aligned; a dy one float into its buffer takes 4-byte
    copies."""
    x, dt, dy = (torch.zeros(2, 8, 64) for _ in range(3))
    bc = torch.zeros(2, 8, 32)
    bm, cm = bc[..., :16], bc[..., 16:]
    assert bwd_tma_route(x, dt, bm, cm, dy)
    off = torch.zeros(2 * 8 * 64 + 1)[1:].view(2, 8, 64)
    assert not bwd_tma_route(x, dt, bm, cm, off)
    assert not bwd_tma_route(x[..., :62].contiguous(), dt[..., :62].contiguous(),
                             bm, cm, dy[..., :62].contiguous())
