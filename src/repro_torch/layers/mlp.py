"""Gated / plain MLP blocks; ``impl="abft"`` routes the projections
through the checksummed matmul (SDC tier 1)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

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


def dot(x: torch.Tensor, w: torch.Tensor,
        impl: Optional[str] = None) -> torch.Tensor:
    """``x @ w``, or with ``impl="abft"`` its checksummed twin: a single
    corrupted output element is located and corrected in place, at float32
    compute cost, and the result comes back in x's dtype."""
    if impl == "abft":
        from repro_torch.kernels.abft_matmul.ops import abft_dot

        return abft_dot(x, w)
    return x @ w


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              act: str, impl: Optional[str] = None) -> torch.Tensor:
    """Weights arrive in the compute dtype (cast once at load)."""
    fn = _act(act)
    h = dot(x, params["w_in"], impl)
    if act in ("silu", "gelu"):
        h = fn(dot(x, params["w_gate"], impl)) * h
    else:
        h = fn(h)
    return dot(h, params["w_out"], impl)
