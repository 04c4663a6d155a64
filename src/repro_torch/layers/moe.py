"""Top-k Mixture-of-Experts with capacity-bounded dispatch (the
reference's ``layers/moe.py``).

Expert compute is ``B * E * C * (...)`` with ``C = ceil(S * k / E *
capacity_factor)``: about ``capacity_factor`` x the active-expert FLOPs,
never the dense all-experts product.  Token -> slot routing is computed
independently per batch row; for decode (S == 1) the batch itself is the
token axis.

Dispatch writes each kept token copy into its own slot by index (no
accumulating scatter: the result and its backward are deterministic on
the card); copies past an expert's capacity all land in the overflow
slot ``E*C``, which no expert reads and whose combine weight is zero.
The combine is a gather whose backward is deterministic under
``torch.use_deterministic_algorithms``.

On a mesh (``par``, see ``train/mesh_step.py``) each rank computes only
its own experts (``par.expert_range``) and its ``d_ff`` columns; the
dispatch input and the gate weights enter through ``par.enter_shard``
(identity forward, gradient summed over the ranks that share the
tokens) and the combined output leaves through ``par.exit_shard`` (a sum
over those ranks in which each token copy has one non-zero addend for
its expert, summed in rank order).  The aux loss's expert means are the
whole batch's (``par.batch_mean`` over the ``"data"`` ranks).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def moe_init(normal: Callable, d_model: int, d_ff: int,
             num_experts: int) -> Dict[str, torch.Tensor]:
    """``normal(shape, std)`` draws one weight; the router is drawn in
    float32 (the reference keeps it so; the forward casts it with the
    other weights)."""
    s_in = d_model ** -0.5
    s_out = d_ff ** -0.5
    return {
        "router": normal((d_model, num_experts), s_in).float(),
        "w_in": normal((num_experts, d_model, d_ff), s_in),
        "w_gate": normal((num_experts, d_model, d_ff), s_in),
        "w_out": normal((num_experts, d_ff, d_model), s_out),
    }


def _capacity(tokens: int, num_experts: int, k: int, cf: float) -> int:
    c = -(-tokens * k * cf // num_experts)
    return max(int(c), 1)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` as a comparison: no range check (a host sync
    on the card), so a decode step can be captured in a CUDA graph."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _live_index(num_experts: int, dead) -> list:
    return [e for e in range(num_experts) if e not in dead]


def router_probs(logits: torch.Tensor, num_experts: int,
                 dead_experts=()) -> torch.Tensor:
    """Router distribution over experts; (..., E) logits -> (..., E) probs.

    With ``dead_experts`` the softmax runs on the compacted live columns
    and scatters back (not a -inf mask over all E): the reduction order is
    that of a model holding just the survivor experts, so degraded routing
    is bit-exact against ``drop_experts``; dead experts get exactly zero
    mass."""
    dead = tuple(sorted({int(e) for e in dead_experts}))
    if not dead:
        return torch.softmax(logits, dim=-1)
    live_idx = torch.tensor(_live_index(num_experts, dead),
                            device=logits.device)
    sub = torch.softmax(logits.index_select(-1, live_idx), dim=-1)
    out = torch.zeros_like(logits)
    out[..., live_idx] = sub
    return out


def drop_experts(params: Dict[str, torch.Tensor],
                 dead_experts) -> Dict[str, torch.Tensor]:
    """Physically remove lost experts: slice their router columns and
    weight rows out.  Running the result with the survivor expert count
    is bit-identical to running the full model with ``dead_experts``
    masked in ``moe_apply``."""
    dead = set(int(e) for e in dead_experts)
    num = params["router"].shape[1]
    keep = torch.tensor(_live_index(num, dead),
                        device=params["router"].device)
    return {
        "router": params["router"].index_select(1, keep),
        "w_in": params["w_in"].index_select(0, keep),
        "w_gate": params["w_gate"].index_select(0, keep),
        "w_out": params["w_out"].index_select(0, keep),
    }


def moe_apply(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
              num_experts: int, k: int, capacity_factor: float,
              act: Callable, compute_dtype, dead_experts=(), par=None):
    """x: (B, S, D) -> ((B, S, D), aux loss).

    ``dead_experts`` (expert ids; it shapes capacity) is graceful
    degradation after an expert slice dies: the softmax runs over the
    surviving columns only, and capacity and the Switch aux loss are
    computed from the live count.  ``par`` (a mesh's hooks, None on one
    rank) holds this rank's expert range; its ``w_*`` leaves are then the
    rank's experts and ``d_ff`` columns."""
    B, S, D = x.shape
    decode = S == 1
    if decode:
        # fold batch into the token axis; a single "row"
        x = x.reshape(1, B, D)
        B, S = 1, B
    E = num_experts
    dead = tuple(sorted({int(e) for e in dead_experts}))
    if any(e < 0 or e >= E for e in dead):
        raise ValueError(f"dead_experts {dead} out of range for E={E}")
    live = E - len(dead)
    if live <= 0:
        raise ValueError(f"all {E} experts dead: nothing to route to")
    k = min(k, live)
    C = _capacity(S, live, k, capacity_factor)

    router = params["router"].to(torch.float32)
    logits = x.to(torch.float32) @ router                      # (B,S,E)
    probs = router_probs(logits, E, dead)                      # (B,S,E)
    gate_w, gate_i = torch.topk(probs, k, dim=-1)              # (B,S,k)
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)

    # load-balancing auxiliary loss (Switch-style, over live experts);
    # the live columns are selected before the means, so the reductions
    # run over the layout a survivor-only model has (bit-exact aux)
    top1 = _one_hot(gate_i[..., 0], E)
    if dead:
        live_idx = torch.tensor(_live_index(E, dead), device=x.device)
        probs_l = probs.index_select(-1, live_idx)
        top1 = top1.index_select(-1, live_idx)
    else:
        probs_l = probs
    me = probs_l.mean(dim=(0, 1))                              # (live,)
    ce = top1.to(torch.float32).mean(dim=(0, 1))
    if par is not None:
        # the batch's statistics, not the rank's rows'
        me, ce = par.batch_mean(me), par.batch_mean(ce)
    aux_loss = live * torch.sum(me * ce)

    # ---- slot assignment, per batch row ----
    T = S * k
    fe = gate_i.reshape(B, T)                                  # expert of each copy
    fw = gate_w.reshape(B, T)
    oh = _one_hot(fe, E)                                       # (B,T,E)
    pos = torch.gather(torch.cumsum(oh, dim=1), 2,
                       fe[..., None])[..., 0] - 1              # (B,T)
    keep = pos < C
    dest = torch.where(keep, fe * C + pos, torch.full_like(fe, E * C))

    xd = x if par is None else par.enter_shard(x)
    xs = torch.repeat_interleave(xd, k, dim=1)                 # (B,T,D)
    brow = torch.arange(B, device=x.device)[:, None]
    # every kept copy owns its slot: an index write, no accumulation
    slots = xs.new_zeros(B, E * C + 1, D)
    slots[brow, dest] = xs
    xe = slots[:, : E * C].reshape(B, E, C, D)

    e0, El = (0, E) if par is None else par.expert_range(E)
    if El != E:
        xe = xe[:, e0:e0 + El]

    # ---- expert computation ----
    cd = compute_dtype
    w_in = params["w_in"].to(cd)
    w_gate = params["w_gate"].to(cd)
    w_out = params["w_out"].to(cd)
    xc = xe.to(cd)
    h = torch.einsum("becd,edf->becf", xc, w_in)
    g = torch.einsum("becd,edf->becf", xc, w_gate)
    h = act(g) * h
    ye = torch.einsum("becf,efd->becd", h, w_out)              # (B,El,C,D)

    # ---- combine ----
    flat = F.pad(ye.reshape(B, El * C, D),
                 (0, 0, e0 * C, (E - e0 - El) * C + 1))        # (B,E*C+1,D)
    back = flat[brow, dest]                                    # (B,T,D)
    if par is not None:
        fw = par.enter_shard(fw)
    back = back * (fw * keep)[..., None]
    y = back.reshape(B, S, k, D).sum(dim=2)
    if par is not None:
        y = par.exit_shard(y)
    if decode:
        y = y.reshape(S, 1, D)
    return y.to(cd), aux_loss
