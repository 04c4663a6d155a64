"""Host wrappers of the CUDA checkpoint-codec kernels
(``csrc/ckpt_codec.cu``), which replace the TPU kernels
``repro/kernels/ckpt_codec/kernel.py:quantize_blocks`` and
``dequantize_blocks``."""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ckpt_codec.ref import BLOCK, block_meta


@functools.lru_cache(maxsize=None)
def _entries():
    lib = build.library()
    qf = lib.repro_ckpt_quantize
    qf.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    qf.restype = ctypes.c_int
    df = lib.repro_ckpt_dequantize
    df.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                           ctypes.c_void_p]
    df.restype = ctypes.c_int
    return qf, df


def quantize_blocks(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: a contiguous float32 or bfloat16 CUDA tensor of any shape,
    16-byte aligned -> (q (NB, 256) int8, scales (NB,) float32), NB =
    ceil(numel / 256), the last block zero-filled."""
    if x.device.type != "cuda":
        raise ValueError(f"quantize_blocks runs on a CUDA device, got "
                         f"{x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("quantize_blocks needs a contiguous, 16-byte "
                         "aligned tensor")
    _, nb = block_meta(tuple(x.shape))
    q = torch.empty(nb, BLOCK, dtype=torch.int8, device=x.device)
    scales = torch.empty(nb, dtype=torch.float32, device=x.device)
    err = _entries()[0](x.data_ptr(), q.data_ptr(), scales.data_ptr(),
                        x.numel(), build.dtype_code(x.dtype),
                        build.stream_ptr(x.device))
    build.check(err, "quantize_blocks")
    quantize_blocks.launches += 1
    return q, scales


quantize_blocks.launches = 0


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor,
                      shape) -> torch.Tensor:
    """q: (NB, 256) int8 and scales: (NB,) float32 on one CUDA device ->
    a float32 tensor of ``shape`` (the first prod(shape) decoded
    elements)."""
    dev = q.device
    if dev.type != "cuda" or scales.device != dev:
        raise ValueError("dequantize_blocks runs on one CUDA device")
    if (q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] != BLOCK
            or scales.dtype != torch.float32
            or scales.shape != (q.shape[0],)):
        raise ValueError(f"q {tuple(q.shape)} {q.dtype}, scales "
                         f"{tuple(scales.shape)} {scales.dtype}")
    if not (q.is_contiguous() and scales.is_contiguous()) or \
            q.data_ptr() % 4 or scales.data_ptr() % 4:
        raise ValueError("dequantize_blocks needs contiguous, 4-byte "
                         "aligned q and scales")
    n = math.prod(shape) if shape else 1
    if n > q.numel():
        raise ValueError(f"shape {tuple(shape)} needs {n} elements, the "
                         f"payload holds {q.numel()}")
    y = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    err = _entries()[1](q.data_ptr(), scales.data_ptr(), y.data_ptr(), n,
                        build.stream_ptr(dev))
    build.check(err, "dequantize_blocks")
    dequantize_blocks.launches += 1
    return y


dequantize_blocks.launches = 0
