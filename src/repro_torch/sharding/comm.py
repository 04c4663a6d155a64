"""Every collective of the port's meshes, in one module.

The transport is ``gloo``: the ranks of a run may share one card, and
NCCL refuses two ranks on one device.  A CUDA tensor is copied to host
memory, exchanged there, and copied back; only ``all_gather`` and
``all_reduce`` are used (gloo has no reduce-scatter).
A later transport swaps in here alone.

Sums are taken in a fixed order: ``ordered_sum`` gathers every rank's
tensor and adds them in group order (in float32 for a narrower dtype),
so every rank of a group gets the same bits, run after run.

The autograd functions carry the collectives of the mesh step
(``train/mesh_step.py``) through the backward pass (the library's
``torch.distributed.nn.functional.all_gather`` would differentiate
through reduce-scatter or all-to-all, which this transport lacks):

- ``enter`` (Megatron's f): identity forward, gradient summed over the
  group — a replicated input entering rank-partial computation;
- ``leave`` (Megatron's g): forward sum over the group, identity
  backward — rank-partial results made whole on every rank;
- ``weighted_sum``: forward sums weighted per-rank values, backward
  sums the gradient over the group and weights it — a batch statistic
  whose row mean the group's ranks split;
- ``gather_sum``: forward gathers a leaf's shards along a dim (FSDP),
  backward sums the whole gradient over the group and keeps this rank's
  slice (each rank saw other data);
- ``gather_slice``: forward gathers the same way, backward keeps this
  rank's slice unsummed (every rank of the group ran the same
  computation on the gathered leaf, so their gradients are equal).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

Group = Optional[object]

# host seconds and bytes received by each collective of this process
# (``reset_stats`` / ``stats``): what a mesh step spends moving data
_STATS: Dict[str, List[float]] = {}


def reset_stats() -> None:
    _STATS.clear()


def stats() -> Dict[str, Dict[str, float]]:
    """{op: {"calls", "seconds", "bytes"}} since the last reset."""
    return {k: {"calls": v[0], "seconds": v[1], "bytes": v[2]}
            for k, v in _STATS.items()}


def _note(op: str, t0: float, nbytes: int) -> None:
    rec = _STATS.setdefault(op, [0, 0.0, 0])
    rec[0] += 1
    rec[1] += time.perf_counter() - t0
    rec[2] += nbytes


def group_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _host(x: torch.Tensor) -> torch.Tensor:
    x = x.detach()
    return (x.cpu() if x.device.type != "cpu" else x).contiguous()


def all_gather(x: torch.Tensor, group: Group) -> List[torch.Tensor]:
    """Every rank's ``x`` (same shape on all), in group order, on
    ``x``'s device."""
    if group is None:
        return [x]
    t0 = time.perf_counter()
    h = _host(x)
    out = [torch.empty_like(h) for _ in range(group_size(group))]
    dist.all_gather(out, h, group=group)
    out = [o.to(x.device) for o in out]
    _note("all_gather", t0, h.numel() * h.element_size() * len(out))
    return out


def ordered_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of every rank's ``x`` in group order (float32 accumulation
    for narrower floats), the same bits on every rank."""
    if group is None:
        return x
    parts = all_gather(x, group)
    acc_dtype = (torch.float32 if x.is_floating_point()
                 and x.element_size() < 4 else x.dtype)
    acc = parts[0].to(acc_dtype).clone()
    for p in parts[1:]:
        acc += p.to(acc_dtype)
    return acc.to(x.dtype)


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """gloo's own all-reduce (a plain sum; used only to time against the
    compressed reduction)."""
    if group is None:
        return x
    t0 = time.perf_counter()
    h = _host(x).clone()
    dist.all_reduce(h, group=group)
    out = h.to(x.device)
    _note("all_reduce", t0, h.numel() * h.element_size())
    return out


def _cat_gather(x: torch.Tensor, group: Group, dim: int,
                sizes: Sequence[int]) -> torch.Tensor:
    """Gather shards of unequal length ``sizes`` along ``dim``: padded to
    the largest, gathered, trimmed and concatenated in group order."""
    m = max(sizes)
    pad = m - x.shape[dim]
    xp = x
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        xp = torch.cat([x, x.new_zeros(shape)], dim=dim)
    parts = all_gather(xp, group)
    return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)],
                     dim=dim)


def _own_slice(g: torch.Tensor, group: Group, dim: int,
               sizes: Sequence[int]) -> torch.Tensor:
    r = group_rank(group)
    return g.narrow(dim, sum(sizes[:r]), sizes[r]).contiguous()


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ordered_sum(g.contiguous(), ctx.group), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return ordered_sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _WeightedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, weight):
        ctx.group, ctx.weight = group, weight
        return ordered_sum((x * weight).contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return ordered_sum(g.contiguous(), ctx.group) * ctx.weight, None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sizes):
        ctx.group, ctx.dim, ctx.sizes = group, dim, sizes
        if dim is None:
            return x.view_as(x)
        return _cat_gather(x.contiguous(), group, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        g = ordered_sum(g.contiguous(), ctx.group)
        if ctx.dim is not None:
            g = _own_slice(g, ctx.group, ctx.dim, ctx.sizes)
        return g, None, None, None


class _GatherSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sizes):
        ctx.group, ctx.dim, ctx.sizes = group, dim, sizes
        return _cat_gather(x.contiguous(), group, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group, ctx.dim, ctx.sizes), None, None, None


def enter(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group is None else _Enter.apply(x, group)


def leave(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group is None else _Leave.apply(x, group)


def weighted_sum(x: torch.Tensor, group: Group,
                 weight: float) -> torch.Tensor:
    """``sum_r weight_r * x_r`` over the group, with the gradient every
    rank's loss sends back to it: a batch statistic (a mean over rows
    that the group's ranks split) used by every rank's loss."""
    if group is None:
        return x
    return _WeightedSum.apply(x, group, float(weight))


def gather_sum(x: torch.Tensor, group: Group, dim: Optional[int],
               sizes: Sequence[int] = ()) -> torch.Tensor:
    """FSDP use of a leaf stored split along ``dim`` over ``group``
    (``dim=None``: stored whole on every rank, only the gradient is
    summed)."""
    if group is None:
        return x
    return _GatherSum.apply(x, group, dim, tuple(sizes))


def gather_slice(x: torch.Tensor, group: Group, dim: int,
                 sizes: Sequence[int]) -> torch.Tensor:
    if group is None:
        return x
    return _GatherSlice.apply(x, group, dim, tuple(sizes))
