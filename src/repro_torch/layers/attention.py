"""Attention, plain PyTorch: GQA/MQA softmax attention with sliding
window, soft-capping, bidirectional mode, and single-token decode against
a KV cache.

These are the plain versions the kernels are held against: ``mha_einsum``
for flash attention (``kernels/flash_attention``) and ``decode_mha`` for
paged decode (``kernels/paged_attention``).  Operands stay in the compute
dtype; products accumulate in fp32 (operands are upcast, which is exact
for bf16) and the softmax runs in fp32, as in the reference.

q: (B,S,H,hd); k,v: (B,Skv,K,hd) with H % K == 0.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.3819763e38  # large negative, safe in fp32


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return torch.tanh(logits / cap) * cap
    return logits


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
          window: int) -> torch.Tensor:
    """Boolean mask (..., Sq, Sk): True = attend."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m = m & (kp <= qp)
    if window and window > 0:
        m = m & (qp - kp < window)
    return m


def _repeat_kv(k: torch.Tensor, G: int) -> torch.Tensor:
    """(B,T,K,hd) -> (B,T,K*G,hd)."""
    if G == 1:
        return k
    B, T, K, hd = k.shape
    return k[:, :, :, None, :].expand(B, T, K, G, hd).reshape(B, T, K * G,
                                                               hd)


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    # the scale is rounded to the compute dtype first, as the reference's
    # ``q * jnp.asarray(scale, q.dtype)`` (``full`` makes it on the device,
    # with no host copy, so the plain versions can be captured in a graph)
    return q * torch.full((), scale, dtype=q.dtype, device=q.device)


def mha_einsum(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale else hd ** -0.5
    qq = _scaled(q, scale)
    kk = _repeat_kv(k, G)
    vv = _repeat_kv(v, G)
    logits = torch.einsum("bshd,bthd->bhst", qq.float(), kk.float())
    logits = _softcap(logits, softcap)
    q_pos = torch.arange(S, dtype=torch.int32, device=q.device)
    k_pos = torch.arange(Skv, dtype=torch.int32, device=q.device)
    m = _mask(q_pos, k_pos, causal=causal, window=window)      # (S,Skv)
    logits = torch.where(m[None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhst,bthd->bshd", p.float(), vv.float())
    return o.to(q.dtype)


def decode_mha(q, k_cache, v_cache, cache_pos, cur_pos, *, window=0,
               softcap=0.0, scale: Optional[float] = None):
    """Single-token decode attention against a KV cache.

    q: (B,1,H,hd); k_cache/v_cache: (B,Sc,K,hd);
    cache_pos: (Sc,) int shared by the rows, or (B,Sc) int, each row's own
    — the absolute position stored in each slot (-1 empty);
    cur_pos: int or (B,) int tensor — absolute position of each query token.
    """
    B, _, H, hd = q.shape
    Sc, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = scale if scale else hd ** -0.5
    qq = _scaled(q, scale).reshape(B, K, G, hd)
    logits = torch.einsum("bkgd,btkd->bkgt", qq.float(), k_cache.float())
    logits = _softcap(logits, softcap)
    cur = torch.as_tensor(cur_pos, device=q.device).reshape(-1, 1)  # (B|1,1)
    pos = cache_pos if cache_pos.dim() == 2 else cache_pos[None, :]
    ok = (pos >= 0) & (pos <= cur)
    if window and window > 0:
        ok = ok & (cur - pos < window)
    logits = torch.where(ok[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bkgt,btkd->bkgd", p.float(), v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)
