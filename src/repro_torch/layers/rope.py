"""Rotary position embeddings: standard RoPE and Qwen2-VL's multi-axis
M-RoPE.

Convention: "rotate half" over contiguous halves of head_dim (llama/gemma
style).  All trig in fp32, computed the reference's way.
"""
from __future__ import annotations

from typing import Sequence

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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: Sequence[int],
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL multi-axis RoPE.  x (B,S,H,hd); positions (3, B, S) int,
    the temporal / height / width ids; ``sections`` split head_dim // 2
    over the three axes (their sum is head_dim // 2): frequency i takes
    its angle from the axis whose section holds it."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum "
                         f"to head_dim // 2 = {half}")
    cos3, sin3 = _rope_angles(positions, x.shape[-1], theta)  # (3,B,S,half)
    cos, sin, start = [], [], 0
    for i, sec in enumerate(sections):
        cos.append(cos3[i, ..., start:start + sec])
        sin.append(sin3[i, ..., start:start + sec])
        start += sec
    return _rotate(x, torch.cat(cos, dim=-1), torch.cat(sin, dim=-1))


def make_positions(batch: int, seq: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    return (pos + offset).expand(batch, seq)
