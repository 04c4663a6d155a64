"""Checkpoint codecs: lossless passthrough and int8 block quantization
(the reference's ``core/codec.py``).

int8 halves (vs bf16) / quarters (vs fp32) checkpoint bytes -> the Young/Daly
cost C drops by the same factor -> the optimal period shrinks by sqrt(ratio)
and more checkpoints fit the same overhead budget (DESIGN.md S3/S4).

Two encode paths share one payload layout (int8 q-blocks followed by fp32
per-block scales), so the manifest records codec "int8" either way and
restore is identical:

- ``Int8BlockCodec``: numpy-side, runs in the writer pool off the BSP
  critical path.  Decode side for both paths.
- ``DeviceCodec``: quantizes *on the card before the copy to the host*,
  so the device->host link and the disk see ~3.9x fewer bytes, and
  decodes int8 leaves on the card at restore (4x fewer bytes to the
  device).  Backend: the CUDA kernels of ``kernels/ckpt_codec`` for CUDA
  tensors, their plain PyTorch version for CPU tensors — both byte-
  identical to this file's numpy codec.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.ckpt_codec.ops import (block_meta, dequantize,
                                                quantize)

BLOCK = 256


class Codec:
    name = "base"

    def encode(self, arr: np.ndarray) -> Tuple[np.ndarray, Dict[str, Any]]:
        raise NotImplementedError

    def decode(self, payload: np.ndarray, meta: Dict[str, Any]) -> np.ndarray:
        raise NotImplementedError


class Int8BlockCodec(Codec):
    name = "int8"

    def encode(self, arr: np.ndarray):
        shape = arr.shape
        flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
        pad = (-flat.size) % BLOCK
        if pad:
            flat = np.pad(flat, (0, pad))
        blocks = flat.reshape(-1, BLOCK)
        scale = np.abs(blocks).max(axis=1) / 127.0
        safe = np.maximum(scale, 1e-12)
        q = np.clip(np.rint(blocks / safe[:, None]), -127, 127).astype(np.int8)
        # payload layout: int8 data blocks followed by fp32 scales (as bytes)
        payload = np.concatenate(
            [q.reshape(-1).view(np.uint8),
             scale.astype(np.float32).view(np.uint8)])
        return payload, {"shape": list(shape), "pad": int(pad),
                         "blocks": int(blocks.shape[0])}

    def decode(self, payload: np.ndarray, meta: Dict[str, Any]) -> np.ndarray:
        nb = meta["blocks"]
        q = payload[: nb * BLOCK].view(np.int8).reshape(nb, BLOCK)
        scale = payload[nb * BLOCK:].view(np.float32)
        flat = (q.astype(np.float32) * scale[:, None]).reshape(-1)
        if meta["pad"]:
            flat = flat[: -meta["pad"]]
        return flat.reshape(meta["shape"])


class DeviceCodec:
    """Int8 encoder/decoder on a tensor's own device, producing and
    reading Int8BlockCodec-compatible payloads.

    ``encode`` returns tensors on the leaf's device (q int8 blocks + fp32
    scales): the caller copies those to the host instead of the float
    leaf, then streams them back-to-back into one .npy payload (see
    io_engine.write_npy) — no host concatenation copy."""

    name = "int8"

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: any shape/float dtype -> (q (NB, BLOCK) int8, scales (NB,)
        f32), both on x's device."""
        return quantize(x)

    def decode(self, q: torch.Tensor, scales: torch.Tensor,
               shape) -> torch.Tensor:
        """The inverse, on q's device: a float32 tensor of ``shape``."""
        return dequantize(q, scales, tuple(shape))

    @staticmethod
    def block_meta(shape) -> Dict[str, Any]:
        """Manifest metadata for a leaf shape (matches Int8BlockCodec's)."""
        pad, blocks = block_meta(tuple(shape))
        return {"shape": list(shape), "pad": pad, "blocks": blocks}


CODECS: Dict[str, Codec] = {"int8": Int8BlockCodec()}
