"""Mamba-1 selective-SSM layer (falcon-mamba-7b family), PyTorch port of
the reference's ``models/mamba.py`` serving path.

Recurrence: ``h_t = exp(dt_t A) h_{t-1} + (dt_t B_t) x_t``;  ``y_t = C_t .
h_t + D x_t`` with diagonal A, per-channel dt.  A prompt of more than one
token is scanned by ``kernels/selective_scan`` (the CUDA kernel on the
card, its plain version on the CPU) from the cache row's state; one token
against a cache is a single elementwise step, as in the reference, and
launches no scan.  Training runs the same scan with its backward as the
gradient (``ops.SelectiveScanFunction``: the scan-backward kernel on the
card, the plain reverse scan on the CPU), where the reference takes
autodiff of its chunked scan.

The dtype points are the reference's: the projections run in the compute
dtype; the depthwise conv sums in float32 from the compute-dtype weights
and rounds back; ``dt`` is a compute-dtype softplus cast to float32; ``A =
-exp(A_log)``, the scan and ``y + D x`` are float32, cast to the compute
dtype before the ``silu(z)`` gate.  ``A_log`` and ``D`` stay float32 (the
reference's ``_KEEP_FP32``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.layers.norms import rms_norm
from repro_torch.models.base import ModelConfig

Params = Dict[str, torch.Tensor]


def ssm_init(cfg: ModelConfig, normal: Callable, const: Callable) -> Params:
    """The reference's shapes and scales.  ``normal(shape, std)`` draws a
    weight; ``const(name, tensor)`` places a float32 constant (both cast
    as the caller loads weights)."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, w = cfg.resolved_dt_rank, cfg.conv_width
    f32 = torch.float32
    return {
        "in_proj": normal((d, 2 * di), d ** -0.5),
        "conv_w": normal((w, di), 0.1),
        "conv_b": const("conv_b", torch.zeros(di, dtype=f32)),
        "x_proj": normal((di, dtr + 2 * n), di ** -0.5),
        "dt_w": normal((dtr, di), dtr ** -0.5),
        "dt_b": const("dt_b", torch.full((di,), -4.6, dtype=f32)),
        "A_log": const("A_log", torch.log(
            torch.arange(1, n + 1, dtype=f32).expand(di, n).contiguous())),
        "D": const("D", torch.ones(di, dtype=f32)),
        "out_proj": normal((di, d), di ** -0.5),
    }


def _causal_conv(x: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time by shifted adds.  x: (B, S, C);
    conv_w: (W, C).  ``state`` (B, W-1, C), the previous W-1 inputs, is
    prepended (zeros without it).  Returns (y, new_state): the last W-1
    pre-conv inputs, zero-padded for a prompt shorter than W-1."""
    W = conv_w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(W):
        y = y + xp[:, k:k + S].float() * conv_w[k].float()
    y = (y + conv_b.float()).to(x.dtype)
    return y, xp[:, S:]


def ssm_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              par=None) -> torch.Tensor:
    """One SSM layer with its residual.  x: (B, S, D).  ``cache``
    {"conv": (B, W-1, Di), "h": (B, Di, N) float32} is read as the state
    before x and overwritten in place with the state after it.  ``par``
    (train mode on a mesh, ``train/mesh_step.py``): the leaves hold the
    rank's Di / tp channels (``in_proj`` its x then z columns), the
    row-parallel ``x_proj`` product is summed over ``"model"`` and the
    output projection's too."""
    B, S, _ = x.shape
    n = cfg.ssm_state
    dtr = cfg.resolved_dt_rank
    s = p["ssm"]
    di = s["in_proj"].shape[-1] // 2                          # the rank's

    h_in = rms_norm(x, p["ln"], cfg.norm_eps)
    if par is not None:
        h_in = par.enter_tp(h_in)
    xi, z = (h_in @ s["in_proj"]).split(di, dim=-1)           # (B, S, Di)
    xi, new_conv = _causal_conv(xi, s["conv_w"], s["conv_b"],
                                cache["conv"] if cache is not None else None)
    xi = F.silu(xi)

    bcd = xi @ s["x_proj"]                                    # (B, S, dtr+2N)
    if par is not None:
        bcd = par.sum_tp(bcd)
    dt = F.softplus(bcd[..., :dtr] @ s["dt_w"] + s["dt_b"]).float()
    bcf = bcd[..., dtr:].float()
    bm, cm = bcf[..., :n], bcf[..., n:]                       # (B, S, N)
    A = -torch.exp(s["A_log"].float())                        # (Di, N)
    xf = xi.float()

    if S == 1 and cache is not None:                          # decode step
        decay = torch.exp(dt[:, 0, :, None] * A)              # (B, Di, N)
        h_last = (decay * cache["h"]
                  + (dt[:, 0] * xf[:, 0])[..., None] * bm[:, 0, None, :])
        y = torch.einsum("bdn,bn->bd", h_last, cm[:, 0])[:, None]
    else:
        h0 = (cache["h"] if cache is not None
              else torch.zeros(B, di, n, dtype=torch.float32,
                               device=x.device))
        y, h_last = selective_scan(xf, dt, bm, cm, A, h0)
    y = y + s["D"].float() * xf
    y = y.to(x.dtype) * F.silu(z)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h_last)
    out = y @ s["out_proj"]
    if par is not None:
        out = par.exit_tp(out)
    return x + out


def ssm_cache_init(cfg: ModelConfig, batch: int,
                   device) -> Dict[str, torch.Tensor]:
    return {"conv": torch.zeros(batch, cfg.conv_width - 1, cfg.d_inner,
                                dtype=cfg.dtype, device=device),
            "h": torch.zeros(batch, cfg.d_inner, cfg.ssm_state,
                             dtype=torch.float32, device=device)}
