"""Gated / plain MLP blocks (the ABFT projection path waits for the SDC
tier-1 slice)."""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def _act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name in ("silu", "swish"):
        return F.silu
    if name in ("gelu", "gelu_plain"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def mlp_init(normal: Callable, d_model: int, d_ff: int,
             act: str) -> Dict[str, torch.Tensor]:
    """``normal(shape, std)`` draws one weight (see models.transformer)."""
    p = {"w_in": normal((d_model, d_ff), d_model ** -0.5),
         "w_out": normal((d_ff, d_model), d_ff ** -0.5)}
    if act in ("silu", "gelu"):
        p["w_gate"] = normal((d_model, d_ff), d_model ** -0.5)
    return p


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              act: str) -> torch.Tensor:
    """Weights arrive in the compute dtype (cast once at load)."""
    fn = _act(act)
    h = x @ params["w_in"]
    if act in ("silu", "gelu"):
        h = fn(x @ params["w_gate"]) * h
    else:
        h = fn(h)
    return h @ params["w_out"]
