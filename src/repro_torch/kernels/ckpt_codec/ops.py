"""Public codec entry: arbitrary-shape leaves <-> int8 blocks + scales.
The plain version for CPU tensors, the CUDA kernels for CUDA tensors.

``quantize`` reads float32 and bfloat16 leaves as they are; other float
dtypes are upcast to float32 first."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ckpt_codec.kernel import (dequantize_blocks,
                                                   quantize_blocks)
from repro_torch.kernels.ckpt_codec.ref import (block_meta, dequantize_ref,
                                                quantize_ref)

__all__ = ["block_meta", "quantize", "dequantize"]


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: any shape/float dtype -> (q (NB, 256) int8, scales (NB,) f32)."""
    if x.device.type == "cpu":
        return quantize_ref(x)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    return quantize_blocks(x.contiguous())


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               shape) -> torch.Tensor:
    """Inverse of ``quantize``: a float32 tensor of ``shape``."""
    if q.device.type == "cpu":
        return dequantize_ref(q, scales, shape)
    return dequantize_blocks(q, scales, shape)
