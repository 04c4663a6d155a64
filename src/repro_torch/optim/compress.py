"""int8 block-quantized gradient compression with error feedback (the
reference's ``optim/compress.py``).

On a pure data-parallel group the gradient reduction can move int8
payloads (about 4x fewer bytes than float32) at the cost of quantization
noise, which error feedback re-injects on the next step so the optimizer
sees an unbiased long-run gradient.

The codec is the checkpoint codec's (``kernels/ckpt_codec/ops``): the
``quantize_blocks`` / ``dequantize_blocks`` kernels on the card, their
plain versions on the CPU; its bytes are ``Int8BlockCodec``'s (256-element
blocks, zero-padded, ``amax / 127`` scales, round half to even).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.kernels.ckpt_codec.ops import block_meta, dequantize, quantize
from repro_torch.sharding import comm
from repro_torch.tree import flatten_named, tree_map, unflatten

BLOCK = 256


def quantize_int8(x: torch.Tensor):
    """x (any shape) -> (q int8 (n_blocks, BLOCK), scale f32 (n_blocks,),
    meta (shape, pad))."""
    q, scale = quantize(x)
    pad, _ = block_meta(tuple(x.shape))
    return q, scale, (tuple(x.shape), pad)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, meta,
                    dtype=torch.float32) -> torch.Tensor:
    shape, _pad = meta
    return dequantize(q, scale, tuple(shape)).to(dtype)


def ef_state_init(params):
    """Error-feedback residual buffers, one per parameter leaf (float32)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(grads, ef, group) -> Tuple[Any, Any]:
    """Error-feedback int8 reduction over ``group`` (a ``"data"`` group of
    ``sharding.api.Mesh``; None is one rank):

        g_eff = g + ef ; q = Q(g_eff) ; new_ef = g_eff - deQ(q) ;
        reduced = sum over ranks of deQ(q_r), in rank order, / n

    What crosses between ranks is the wire format: each rank's int8
    blocks and float32 block scales (gathered), which every rank
    dequantizes and adds in rank order — the same bits on every rank.
    Returns (reduced grads in each leaf's dtype, new ef)."""
    n = comm.group_size(group)
    out, new_ef = [], []
    for (_, g), (_, e) in zip(flatten_named(grads), flatten_named(ef)):
        g_eff = g.to(torch.float32) + e
        q, s, meta = quantize_int8(g_eff)
        new_ef.append(g_eff - dequantize_int8(q, s, meta))
        qs = comm.all_gather(q, group)
        ss = comm.all_gather(s, group)
        acc = dequantize_int8(qs[0], ss[0], meta)
        for qr, sr in zip(qs[1:], ss[1:]):
            acc = acc + dequantize_int8(qr, sr, meta)
        out.append((acc / n).to(g.dtype))
    return unflatten(grads, out), unflatten(ef, new_ef)
