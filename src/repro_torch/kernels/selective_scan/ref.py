"""Plain PyTorch versions of the selective-scan kernels: the direct
sequential recurrence of the reference's ``selective_scan_ref``, and its
backward as an explicit reverse scan (the reference trains through
autodiff of ``models/mamba.py:_ssm_chunked``; its Pallas scan has no
backward)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                       cm: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: (B, S, Di); bm, cm: (B, S, N); a: (Di, N); h0: (B, Di, N).
    ``h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) B_t``, ``y_t = C_t . h_t``.
    Returns (y (B, S, Di), h_last (B, Di, N)), both float32."""
    x, dt, bm, cm, a = (t.float() for t in (x, dt, bm, cm, a))
    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(dt[:, t, :, None] * a)             # (B, Di, N)
        h = decay * h + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cm[:, t]))
    if not ys:
        return x.new_zeros(x.shape), h
    return torch.stack(ys, dim=1), h


def selective_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor,
                           bm: torch.Tensor, cm: torch.Tensor,
                           a: torch.Tensor, h0: torch.Tensor,
                           dy: torch.Tensor,
                           dh_last: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, ...]:
    """Gradients of ``selective_scan_ref``'s (y, h_last) against ``dy``
    (B, S, Di) and ``dh_last`` (B, Di, N; ``None`` = 0): (dx, ddt, dB,
    dC, dA, dh0), float32, shaped as the inputs.  With ``e_t =
    exp(dt_t a)``, the reverse scan runs ``g_t = r_t + C_t dy_t`` (the
    gradient in ``h_t``), ``r_{t-1} = e_t g_t`` from ``r_{S-1} =
    dh_last``; then ``dC_t = sum_d dy_t h_t``, ``dB_t = sum_d g_t dt_t
    x_t``, ``u_t = sum_n g_t B_t`` gives ``dx_t = u_t dt_t``, and ``q_t =
    g_t h_{t-1} e_t`` gives ``ddt_t = sum_n q_t a + u_t x_t`` and ``dA =
    sum_{b,t} q_t dt_t``; ``dh0 = r_{-1}``.  The forward's states are kept
    whole (S x B x Di x N floats)."""
    x, dt, bm, cm, a, dy = (t.float() for t in (x, dt, bm, cm, a, dy))
    B, S, Di = x.shape
    N = a.shape[-1]
    h = h0.float()
    hs, es = [h], []
    for t in range(S):
        e = torch.exp(dt[:, t, :, None] * a)                  # (B, Di, N)
        h = e * h + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
        es.append(e)
        hs.append(h)
    r = (dh_last.float() if dh_last is not None
         else torch.zeros(B, Di, N, dtype=torch.float32, device=x.device))
    dx, ddt = torch.zeros_like(x), torch.zeros_like(x)
    dbm = torch.zeros(B, S, N, dtype=torch.float32, device=x.device)
    dcm = torch.zeros_like(dbm)
    da = torch.zeros(Di, N, dtype=torch.float32, device=x.device)
    for t in reversed(range(S)):
        g = r + dy[:, t, :, None] * cm[:, t, None, :]
        dcm[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dy[:, t])
        dbm[:, t] = torch.einsum("bdn,bd->bn", g, dt[:, t] * x[:, t])
        u = torch.einsum("bdn,bn->bd", g, bm[:, t])
        q = g * hs[t] * es[t]
        ddt[:, t] = (q * a).sum(-1) + u * x[:, t]
        dx[:, t] = u * dt[:, t]
        da = da + torch.einsum("bdn,bd->dn", q, dt[:, t])
        r = es[t] * g
    return dx, ddt, dbm, dcm, da, r


# The kernel's parts (warps) a channel's states are split over and time
# steps a ring stage (``kParts``, ``kT`` in csrc/selective_scan.cu), and
# log2(e) as the kernel rounds it (hopper.cuh's REPRO_LOG2E).
PARTS = 8
TILE = 32
LOG2E = 1.4426950408889634


def states_per_part(n: int, parts: int = PARTS) -> int:
    """A part's states: ceil(n / parts), rounded up to a power of two."""
    per = -(-n // parts)
    return 1 << (per - 1).bit_length()


def part_tree_ref(p: torch.Tensor) -> torch.Tensor:
    """The kernel's fold of the parts' partial sums of y (the last axis):
    the upper half added to the lower half until one value is left,
    ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)) for 8."""
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return p[..., 0]


def selective_scan_parts_ref(x: torch.Tensor, dt: torch.Tensor,
                             bm: torch.Tensor, cm: torch.Tensor,
                             a: torch.Tensor, h0: torch.Tensor,
                             parts: int = PARTS
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's arithmetic in float32, for the CPU tests: the
    decay as exp2(dt * fl32(A log2 e)); the states split into ``parts``
    parts of ``states_per_part`` each (zero-padded past N); each part's
    partial sum of C h over its states in increasing n; the parts' sums
    folded by ``part_tree_ref``.  Same contract as
    ``selective_scan_ref``."""
    x, dt, bm, cm, a = (t.float() for t in (x, dt, bm, cm, a))
    B, S, Di = x.shape
    N = a.shape[-1]
    npl = states_per_part(N, parts)
    pad = (0, parts * npl - N)
    a2 = torch.nn.functional.pad(a, pad) * torch.tensor(LOG2E,
                                                        dtype=torch.float32)
    bm, cm = (torch.nn.functional.pad(t, pad) for t in (bm, cm))
    h = torch.nn.functional.pad(h0.float(), pad)
    ys = []
    for t in range(S):
        decay = torch.exp2(dt[:, t, :, None] * a2)            # (B, Di, P)
        h = decay * h + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
        prod = (cm[:, t, None, :] * h).reshape(B, Di, parts, npl)
        part = prod[..., 0]
        for j in range(1, npl):
            part = part + prod[..., j]
        ys.append(part_tree_ref(part))
    h = h[..., :N].contiguous()
    if not ys:
        return x.new_zeros(x.shape), h
    return torch.stack(ys, dim=1), h


# channels a block of either kernel (``kChan``): one a lane
CHANNELS = 32


def _seq_sum(v: torch.Tensor) -> torch.Tensor:
    """The last axis summed in increasing index, one add at a time."""
    s = v[..., 0]
    for j in range(1, v.shape[-1]):
        s = s + v[..., j]
    return s


def _block_sum(v: torch.Tensor, chan: int) -> torch.Tensor:
    """v (B, Di, P) summed over Di as the backward kernel sums dB and dC:
    each block's ``chan`` channels (zeros past Di) folded by
    ``part_tree_ref``, then the blocks' sums in block order.  (B, P)."""
    B, Di, P = v.shape
    blocks = -(-Di // chan)
    v = torch.nn.functional.pad(v, (0, 0, 0, blocks * chan - Di))
    v = v.reshape(B, blocks, chan, P).transpose(2, 3)    # (B, blk, P, chan)
    return _seq_sum(part_tree_ref(v).transpose(1, 2))


def selective_scan_bwd_parts_ref(x: torch.Tensor, dt: torch.Tensor,
                                 bm: torch.Tensor, cm: torch.Tensor,
                                 a: torch.Tensor, h0: torch.Tensor,
                                 dy: torch.Tensor,
                                 dh_last: Optional[torch.Tensor] = None,
                                 parts: int = PARTS, chan: int = CHANNELS
                                 ) -> Tuple[torch.Tensor, ...]:
    """The backward CUDA kernel's order of operations in float32, for the
    CPU tests (same contract as ``selective_scan_bwd_ref``).  The states
    are recomputed with the forward kernel's decay, exp2(dt * fl32(A
    log2 e)), and split into ``parts`` parts of ``states_per_part``
    (zero-padded past N).  A step's u and sum_n q A are summed over a
    part's states in increasing n; each part's dx (its u times dt) and
    ddt (its u times x plus its sum of q A) are folded over the parts by
    ``part_tree_ref``.  dB and dC are each block's ``chan`` channels
    folded by ``part_tree_ref``, then the blocks in block order
    (``_block_sum``); dA is summed over time in reverse within a batch
    row, then over the rows in row order."""
    x, dt, bm, cm, a, dy = (t.float() for t in (x, dt, bm, cm, a, dy))
    B, S, Di = x.shape
    N = a.shape[-1]
    npl = states_per_part(N, parts)
    pad = (0, parts * npl - N)
    a = torch.nn.functional.pad(a, pad)
    a2 = a * torch.tensor(LOG2E, dtype=torch.float32)
    bm, cm = (torch.nn.functional.pad(t, pad) for t in (bm, cm))
    h = torch.nn.functional.pad(h0.float(), pad)
    hs, es = [h], []
    for t in range(S):
        e = torch.exp2(dt[:, t, :, None] * a2)               # (B, Di, P)
        h = e * h + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
        es.append(e)
        hs.append(h)
    r = (torch.nn.functional.pad(dh_last.float(), pad)
         if dh_last is not None else torch.zeros_like(h))
    dx, ddt = torch.zeros_like(x), torch.zeros_like(x)
    dbm = torch.zeros(B, S, N, dtype=torch.float32, device=x.device)
    dcm = torch.zeros_like(dbm)
    da = torch.zeros_like(h)                                  # (B, Di, P)
    for t in reversed(range(S)):
        g = cm[:, t, None, :] * dy[:, t, :, None] + r
        r = es[t] * g
        q = hs[t] * r                           # g h_{t-1} e = h_{t-1} r_{t-1}
        da = da + q * dt[:, t, :, None]
        u = _seq_sum((g * bm[:, t, None, :]).reshape(B, Di, parts, npl))
        s2 = _seq_sum((q * a).reshape(B, Di, parts, npl))
        dx[:, t] = part_tree_ref(u * dt[:, t, :, None])
        ddt[:, t] = part_tree_ref(u * x[:, t, :, None] + s2)
        dxv = (dt[:, t] * x[:, t])[..., None]
        dbm[:, t] = _block_sum(g * dxv, chan)[..., :N]
        dcm[:, t] = _block_sum(dy[:, t, :, None] * hs[t + 1], chan)[..., :N]
    dA = _seq_sum(da.permute(1, 2, 0))[..., :N]
    return dx, ddt, dbm, dcm, dA.contiguous(), r[..., :N].contiguous()
