"""The plain model of the port's paged decode kernel against the JAX
package on the CPU.

``csrc/paged_attention.cu`` cuts each row's positions into fixed splits
of ``split_positions(hd, dtype)`` positions counted from position 0,
computes an fp32 triple (m, l, acc) per live split and folds a row's
live splits in ascending order.  ``kernels/paged_attention/ref.py``
models that arithmetic (``paged_split_partials``, ``combine_splits``);
here it is held to the JAX ``paged_attention_rkgd`` (Pallas, interpret
mode, a few small cases) and its jnp reference, and to the port's own
``paged_attention_ref``: 2e-5 in float32, 2e-2 in bfloat16 (the
tolerances of tests/test_kernels.py).  Inputs come from numpy seeds.
The cases put lengths at C - 1, C and C + 1, windows across a split
boundary and past whole splits, softcap 0 and 30, an inactive row, G 1,
4 and 8, hd 64 and 128.  A dead split, or a wider table, leaves the
fold's bits unchanged.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import \
    paged_decode_attention as jax_paged
from repro_torch.kernels.paged_attention.ref import (
    combine_splits, paged_attention_ref, paged_attention_split_ref,
    paged_split_partials, split_positions)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
PS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers beside
    timing-sensitive multi-process tests, and idle OpenMP threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(lengths, K, G, hd, mpr, dtype, seed):
    """numpy inputs for both packages: each row maps ``mpr`` distinct live
    pages; a row of length 0 is inactive (zeroed table)."""
    rng = np.random.default_rng(seed)
    R = len(lengths)
    P = R * mpr + 1
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((R, 1, K * G, hd), (P, PS, K, hd), (P, PS, K, hd))]
    if dtype == "bfloat16":
        arrays = [a.astype(ml_dtypes.bfloat16).astype(np.float32)
                  for a in arrays]
    table = rng.permutation(np.arange(1, P))[:R * mpr].reshape(R, mpr)
    table = table.astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    table[lens == 0] = 0
    return arrays, table, lens


def _torch(arrays, table, lens, dtype):
    tdt = DTYPES[dtype][1]
    return ([torch.from_numpy(a.copy()).to(tdt) for a in arrays],
            torch.from_numpy(table.copy()), torch.from_numpy(lens.copy()))


def _jax(arrays, table, lens, dtype):
    jdt = DTYPES[dtype][0]
    return ([jnp.asarray(a).astype(jdt) for a in arrays], jnp.asarray(table),
            jnp.asarray(lens))


def _close(t: torch.Tensor, want, tol: float) -> None:
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _edge_lengths(C, mpr):
    return [0, C - 1, C, C + 1, mpr * PS - 1]


# window 40 crosses the boundary at C from C + 1 and 2 C; window 24 keeps
# only the last split of long rows (whole splits excluded)
@pytest.mark.parametrize("G,hd", [(1, 64), (4, 128), (8, 64), (8, 128),
                                  (16, 256)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (0, 30.0),
                                            (40, 0.0), (24, 30.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_model_matches_the_references(G, hd, window, softcap, dtype):
    C = split_positions(hd, DTYPES[dtype][1])
    mpr = -(-(2 * C + 8) // PS)
    lengths = _edge_lengths(C, mpr)[:-1] + [2 * C, mpr * PS - 1]
    arrays, table, lens = _case(lengths, 2, G, hd, mpr, dtype, seed=G + hd)
    (q, kp, vp), pt, ln = _torch(arrays, table, lens, dtype)
    kw = dict(window=window, softcap=softcap)
    got = paged_attention_split_ref(q, kp, vp, pt, ln, **kw)
    tol = DTYPES[dtype][2]
    _close(got, paged_attention_ref(q, kp, vp, pt, ln, **kw), tol)
    (qj, kj, vj), pj, lj = _jax(arrays, table, lens, dtype)
    _close(got, jax_paged(qj, kj, vj, pj, lj, impl="ref", **kw), tol)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (40, 30.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_model_matches_the_pallas_kernel(window, softcap, dtype):
    """A few small cases against the Pallas kernel in interpret mode."""
    C = split_positions(64, DTYPES[dtype][1])
    mpr = -(-(C + 2) // PS)
    arrays, table, lens = _case([0, C - 1, C, C + 1], 1, 4, 64, mpr, dtype,
                                seed=7)
    (q, kp, vp), pt, ln = _torch(arrays, table, lens, dtype)
    kw = dict(window=window, softcap=softcap)
    got = paged_attention_split_ref(q, kp, vp, pt, ln, **kw)
    (qj, kj, vj), pj, lj = _jax(arrays, table, lens, dtype)
    want = jax_paged(qj, kj, vj, pj, lj, impl="pallas", interpret=True, **kw)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("window", [0, 40])
def test_dead_splits_leave_the_fold_unchanged(window):
    """A wider table (more dead splits) gives the same bits, and so do
    dead splits whose partials hold NaN: the fold skips them."""
    C = split_positions(128, torch.float32)
    mpr = -(-(2 * C + 8) // PS)
    arrays, table, lens = _case([0, C - 1, C + 1, 2 * C + 3], 2, 4, 128,
                                mpr, "float32", seed=3)
    (q, kp, vp), pt, ln = _torch(arrays, table, lens, "float32")
    kw = dict(window=window)
    o = paged_attention_split_ref(q, kp, vp, pt, ln, **kw)
    wide = torch.zeros(len(lens), 40, dtype=torch.int32)
    wide[:, :mpr] = pt
    assert torch.equal(paged_attention_split_ref(q, kp, vp, wide, ln, **kw),
                       o)
    m, l, acc, live = paged_split_partials(q, kp, vp, pt, ln, **kw)
    assert (~live).any() and live.any(dim=1).all()
    dead = ~live[:, None, :, None]
    m2, l2 = (torch.where(dead, torch.nan, t) for t in (m, l))
    acc2 = torch.where(dead[..., None], torch.nan, acc)
    assert torch.equal(combine_splits(m2, l2, acc2, live),
                       combine_splits(m, l, acc, live))
    assert torch.equal(combine_splits(m, l, acc, live).reshape(o.shape), o)


def test_a_split_is_live_only_where_the_row_attends():
    """Splits past the length, or wholly before the window's start, are
    dead; a row of length C - 1 has one live split, C + 1 two."""
    C = split_positions(64, torch.float32)
    assert C == 32
    mpr = -(-(3 * C) // PS)
    arrays, table, lens = _case([0, C - 1, C + 1, 3 * C - 1], 1, 1, 64, mpr,
                                "float32", seed=5)
    (q, kp, vp), pt, ln = _torch(arrays, table, lens, "float32")
    _, _, _, live = paged_split_partials(q, kp, vp, pt, ln)
    assert live.tolist() == [[True, False, False], [True, False, False],
                             [True, True, False], [True, True, True]]
    _, _, _, live = paged_split_partials(q, kp, vp, pt, ln, window=C // 2)
    assert live.tolist() == [[True, False, False], [True, False, False],
                             [True, True, False], [False, False, True]]


def test_split_positions_depends_on_hd_and_dtype_only():
    """C follows a K row's bytes (about 8 KB of K a split) and nothing
    else: the function takes hd and the dtype, and gives a power of two
    from 16 to 256."""
    params = list(split_positions.__code__.co_varnames[
        :split_positions.__code__.co_argcount])
    assert params == ["hd", "dtype"]
    want = {(64, torch.bfloat16): 64, (128, torch.bfloat16): 32,
            (256, torch.bfloat16): 16, (64, torch.float32): 32,
            (128, torch.float32): 16, (32, torch.bfloat16): 128,
            (8, torch.bfloat16): 256}
    for (hd, dt), c in want.items():
        assert split_positions(hd, dt) == c, (hd, dt)
