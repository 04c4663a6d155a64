"""Rotary position embeddings (standard RoPE; M-RoPE waits for the
qwen2-vl slice).

Convention: "rotate half" over contiguous halves of head_dim (llama/gemma
style).  All trig in fp32, computed the reference's way.
"""
from __future__ import annotations

import torch


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) int -> cos/sin (..., S, head_dim//2) fp32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freq = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=positions.device), exps)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    """x (B,S,H,hd); cos/sin (B,S,hd//2) broadcast over heads."""
    half = x.shape[-1] // 2
    xf1 = x[..., :half].float()
    xf2 = x[..., half:].float()
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (B,S,H,hd), positions (B,S) int."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    return _rotate(x, cos, sin)


def make_positions(batch: int, seq: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    return (pos + offset).expand(batch, seq)
