"""Plain PyTorch version of the int8 block codec: the arithmetic of the
host codec (``core/codec.py`` ``Int8BlockCodec``, numpy) and of the TPU
kernel, on tensors.

Every division is tensor by tensor: PyTorch's CUDA ``div`` by a Python
scalar multiplies by the reciprocal, which is not the IEEE quotient the
host codec and the kernel compute, so the plain version would disagree
with both in the last bit of a scale."""
from __future__ import annotations

import math
from typing import Tuple

import torch

BLOCK = 256


def block_meta(shape) -> Tuple[int, int]:
    """(pad, n_blocks) of the packed payload for a leaf shape."""
    size = math.prod(shape) if shape else 1
    pad = int((-size) % BLOCK)
    return pad, int((size + pad) // BLOCK)


def quantize_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: any shape, float dtype -> (q (NB, 256) int8, scales (NB,) f32)."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    amax = blocks.abs().amax(dim=1)
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor,
                   shape) -> torch.Tensor:
    """(NB, 256) int8 and (NB,) f32 -> float32 tensor of ``shape``."""
    n = math.prod(shape) if shape else 1
    flat = (q.to(torch.float32) * scales[:, None]).reshape(-1)
    return flat[:n].reshape(tuple(shape))
