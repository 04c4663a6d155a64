"""RG-LRU recurrent block (RecurrentGemma / Griffin family), PyTorch port
of the reference's ``models/rglru.py``.

Temporal block: ``y = out( gelu(gate(x)) * RG-LRU(conv1d(x_proj(x))) )``.
RG-LRU (per channel):
  r_t = sigmoid(W_r u_t + b_r);  i_t = sigmoid(W_i u_t + b_i)
  a_t = sigmoid(Lambda) ** (c * r_t)          (c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * u_t)

The dtype points are the reference's: the projections and the gate run in
the compute dtype; the depthwise conv sums in float32 and rounds back
(``models/mamba.py:_causal_conv``, the reference's ``_causal_conv``); the
gates, ``log_a``, ``a``, ``b`` and the recurrence are float32; ``lam``
stays float32 (``_KEEP_FP32``).  A prompt runs the recurrence through
``linear_scan`` (plain PyTorch; RG-LRU has no TPU kernel, so the port owes
none); one token against a cache is a single elementwise step, as in the
reference.  Training differentiates the same code (autograd through the
scan's passes), as the reference differentiates ``_scan_chunked``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.layers.mlp import mlp_apply, mlp_init
from repro_torch.layers.norms import rms_norm
from repro_torch.models.base import ModelConfig
from repro_torch.models.mamba import _causal_conv

Params = Dict[str, torch.Tensor]

_C = 8.0
SCAN_CHUNK = 128       # the reference's models/mamba.py:SCAN_CHUNK


def rec_init(cfg: ModelConfig, normal: Callable, ones: Callable,
             zeros: Callable, const: Callable) -> Params:
    """The reference's shapes and scales.  ``normal(shape, std)``,
    ``ones(n)``, ``zeros(n)`` and ``const(name, tensor)`` place a weight
    as the caller loads weights (a stacked train block's initialisers add
    its leading layer axis)."""
    d = cfg.d_model
    w = cfg.lru_width or d
    rec = {
        "x_proj": normal((d, w), d ** -0.5),
        "gate_proj": normal((d, w), d ** -0.5),
        "conv_w": normal((cfg.conv_width, w), 0.1),
        "conv_b": zeros(w),
        "w_i": normal((w, w), w ** -0.5),
        "b_i": zeros(w),
        "w_r": normal((w, w), w ** -0.5),
        "b_r": zeros(w),
        # a = sigmoid(lam) from ~0.9 to ~0.999 at init
        "lam": const("lam", torch.linspace(2.2, 6.9, w,
                                           dtype=torch.float32)),
        "out_proj": normal((w, d), w ** -0.5),
    }
    return {"ln1": ones(d), "rec": rec, "ln2": ones(d),
            "mlp": mlp_init(normal, d, cfg.d_ff, cfg.mlp_act)}


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor):
    """h_t = a_t h_{t-1} + b_t over axis 1, float32.  a, b: (B, S, w);
    h0: (B, w).  Returns (h_all (B, S, w), h_last (B, w)).

    The reference's ``_scan_chunked``: chunks of ``SCAN_CHUNK`` steps (one
    chunk of S when S is not a multiple), each an inclusive scan of the
    pairs (a, b) under (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2) with the
    carried state folded into its first step.  Here each chunk's scan
    doubles its stride (log2 of the chunk's length passes over the chunk)
    where XLA's ``associative_scan`` takes another tree of the same
    combine: the two agree to float32 rounding.  Every pass builds new
    tensors (the unchanged head of the chunk beside the combined tail),
    so autograd differentiates the scan (the train step's RG-LRU
    layers).  The passes' products of a do not depend on the carried
    state: they are taken for every chunk at once, and only the b passes
    run chunk after chunk (the same products in the same order: the bits
    of a chunk-by-chunk scan in three fifths of its launches)."""
    Bd, S = a.shape[:2]
    Q = min(SCAN_CHUNK, S)
    if S % Q:
        Q = S
    a0 = ac = a.reshape((Bd, S // Q, Q) + a.shape[2:])
    acs = []                            # the a of each pass, stride 2^j
    k = 1
    while k < Q:
        acs.append(ac)
        if 2 * k < Q:
            ac = torch.cat([ac[:, :, :k], ac[:, :, k:] * ac[:, :, :-k]],
                           dim=2)
        k *= 2
    outs = []
    h = h0
    for c in range(S // Q):
        bc = b[:, c * Q:(c + 1) * Q]
        bc = torch.cat([bc[:, :1] + a0[:, c, :1] * h[:, None],
                        bc[:, 1:]], dim=1)
        for j, ak in enumerate(acs):
            k = 1 << j
            bc = torch.cat([bc[:, :k], bc[:, k:] + ak[:, c, k:] * bc[:, :-k]],
                           dim=1)
        outs.append(bc)
        h = bc[:, -1]
    return torch.cat(outs, dim=1), h


def rec_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              par=None) -> torch.Tensor:
    """One RG-LRU layer and its MLP block with their residuals.  x: (B, S,
    D).  ``cache`` {"conv": (B, W-1, w), "h": (B, w) float32} is read as
    the state before x and overwritten in place with the state after
    it.  ``par`` (train mode on a mesh, ``train/mesh_step.py``): the
    leaves hold the rank's w / tp channels; the gates read every channel
    of the convolved input, gathered over ``"model"``; the output
    projection and the MLP are row-parallel."""
    B, S, _ = x.shape
    rec = p["rec"]
    h_in = rms_norm(x, p["ln1"], cfg.norm_eps)
    if par is not None:
        h_in = par.enter_tp(h_in)
    u = h_in @ rec["x_proj"]                                  # (B, S, w)
    u, new_conv = _causal_conv(u, rec["conv_w"], rec["conv_b"],
                               cache["conv"] if cache is not None else None)
    uf = u.float()
    ug = uf if par is None else par.gather_tp(u).float()      # every channel
    r = torch.sigmoid(ug @ rec["w_r"].float() + rec["b_r"].float())
    i = torch.sigmoid(ug @ rec["w_i"].float() + rec["b_i"].float())
    log_a = _C * r * F.logsigmoid(rec["lam"].float())
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)

    if S == 1 and cache is not None:                          # decode step
        h_last = a[:, 0] * cache["h"] + b[:, 0]
        h_seq = h_last[:, None]
    else:
        h0 = (cache["h"] if cache is not None
              else torch.zeros(B, u.shape[-1], dtype=torch.float32,
                               device=x.device))
        h_seq, h_last = linear_scan(a, b, h0)
    gate = F.gelu(h_in @ rec["gate_proj"], approximate="tanh")
    o = (h_seq.to(x.dtype) * gate) @ rec["out_proj"]
    x = x + (o if par is None else par.exit_tp(o))
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if par is not None:
        h2 = par.enter_tp(h2)
    m = mlp_apply(p["mlp"], h2, cfg.mlp_act)
    x = x + (m if par is None else par.exit_tp(m))
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h_last)
    return x


def rec_cache_init(cfg: ModelConfig, batch: int,
                   device) -> Dict[str, torch.Tensor]:
    w = cfg.lru_width or cfg.d_model
    return {"conv": torch.zeros(batch, cfg.conv_width - 1, w,
                                dtype=cfg.dtype, device=device),
            "h": torch.zeros(batch, w, dtype=torch.float32, device=device)}
