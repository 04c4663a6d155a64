"""The kernels on the meta device: what each kernel allocates, no launch.

A meta tensor carries a shape and a dtype and no data, so a kernel
cannot run on it; the dry run (``launch/dryrun.py``) and the roofline
(``launch/roofline.py``) trace whole steps on it.  For such a trace each
kernel op (``ops.py``) sends meta tensors here: one custom op a kernel
entry, whose fake implementation returns empty tensors of the kernel's
outputs (flash: O and the LSE, never S x S scores) and whose FLOP
formula (``torch.utils.flop_counter``) is the operation count the
kernel's bound in ``chip_smoke.py`` uses: flash forward 4 hd a
(query, key) pair a head, backward 10; the scan forward 6 B S Di N + B
S Di, backward 20 B S Di N; RMSNorm none (its bound is bytes alone, as
the counter counts no elementwise op).  The kernels' scratch (the flash
backward's row sums, the RMSNorm backward's partial sums, the scan
backward's saved states) is not allocated here.

A CPU or CUDA tensor never comes here: the CPU takes the plain versions
and the card the kernels, as before.  Importing this module registers
the ops; ``ops.py`` imports it only when a meta tensor arrives.
"""
from typing import List, Optional, Tuple

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

_NS = "repro_torch"


def attended_pairs(S: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a head attends: ``chip_smoke._attended_pairs``
    in closed form (causal rows see up to ``window`` keys; ``S == Sk``
    when causal)."""
    if not causal:
        return S * Sk
    w = window if window and window < S else S
    return w * (w + 1) // 2 + (S - w) * w


def _no_data(name: str) -> RuntimeError:
    return RuntimeError(f"{_NS}::{name} runs on meta tensors only")


# -- flash attention --------------------------------------------------------

@torch.library.custom_op(f"{_NS}::flash_fwd", mutates_args=())
def flash_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
              lse: bool) -> Tuple[Tensor, Tensor]:
    raise _no_data("flash_fwd")


@flash_fwd.register_fake
def _(q, k, v, causal, window, lse):
    B, S, H, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, H, S) if lse else (0,), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _(q_shape, k_shape, v_shape, causal, window, lse, *a, **kw) -> int:
    B, S, H, hd = q_shape
    return 4 * B * H * hd * attended_pairs(S, k_shape[1], causal, window)


@torch.library.custom_op(f"{_NS}::flash_bwd", mutates_args=())
def flash_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, do: Tensor,
              lse: Tensor, causal: bool, window: int
              ) -> Tuple[Tensor, Tensor, Tensor]:
    raise _no_data("flash_bwd")


@flash_bwd.register_fake
def _(q, k, v, o, do, lse, causal, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _(q_shape, k_shape, *a, **kw) -> int:
    causal, window = a[-2], a[-1]
    B, S, H, hd = q_shape
    return 10 * B * H * hd * attended_pairs(S, k_shape[1], causal, window)


# -- RMSNorm ------------------------------------------------------------------

@torch.library.custom_op(f"{_NS}::rmsnorm_fwd", mutates_args=())
def rmsnorm_fwd(x: Tensor, w: Tensor, rstd: bool) -> Tuple[Tensor, Tensor]:
    raise _no_data("rmsnorm_fwd")


@rmsnorm_fwd.register_fake
def _(x, w, rstd):
    return (torch.empty_like(x),
            x.new_empty((x.shape[0],) if rstd else (0,),
                        dtype=torch.float32))


@torch.library.custom_op(f"{_NS}::rmsnorm_bwd", mutates_args=())
def rmsnorm_bwd(g: Tensor, x: Tensor, w: Tensor,
                rstd: Tensor) -> Tuple[Tensor, Tensor]:
    raise _no_data("rmsnorm_bwd")


@rmsnorm_bwd.register_fake
def _(g, x, w, rstd):
    return torch.empty_like(x), torch.empty_like(w)


# -- selective scan -----------------------------------------------------------

@torch.library.custom_op(f"{_NS}::scan_fwd", mutates_args=())
def scan_fwd(x: Tensor, dt: Tensor, bm: Tensor, cm: Tensor, a: Tensor,
             h0: Tensor) -> Tuple[Tensor, Tensor]:
    raise _no_data("scan_fwd")


@scan_fwd.register_fake
def _(x, dt, bm, cm, a, h0):
    f32 = torch.float32
    return (x.new_empty(x.shape, dtype=f32), h0.new_empty(h0.shape,
                                                           dtype=f32))


@register_flop_formula(torch.ops.repro_torch.scan_fwd)
def _(x_shape, dt_shape, bm_shape, *a, **kw) -> int:
    B, S, Di = x_shape
    N = bm_shape[-1]
    return 6 * B * S * Di * N + B * S * Di


@torch.library.custom_op(f"{_NS}::scan_bwd", mutates_args=())
def scan_bwd(x: Tensor, dt: Tensor, bm: Tensor, cm: Tensor, a: Tensor,
             h0: Tensor, dy: Tensor, dh_last: Optional[Tensor]
             ) -> List[Tensor]:
    raise _no_data("scan_bwd")


@scan_bwd.register_fake
def _(x, dt, bm, cm, a, h0, dy, dh_last):
    f32 = torch.float32
    B, S, _ = x.shape
    N = bm.shape[-1]
    return [x.new_empty(x.shape, dtype=f32), x.new_empty(x.shape, dtype=f32),
            x.new_empty((B, S, N), dtype=f32),
            x.new_empty((B, S, N), dtype=f32),
            a.new_empty(a.shape, dtype=f32),
            h0.new_empty(h0.shape, dtype=f32)]


@register_flop_formula(torch.ops.repro_torch.scan_bwd)
def _(x_shape, dt_shape, bm_shape, *a, **kw) -> int:
    B, S, Di = x_shape
    return 20 * B * S * Di * bm_shape[-1]
