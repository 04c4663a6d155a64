"""Every collective of the port's meshes, in one module.

The ranks of a run share one host (``sharding.launch.spawn`` starts
them, and may start them on one card, where NCCL refuses two ranks).
They exchange tensors through files in the run's directory
(``spawn`` sets ``set_host_dir``), with gloo's barriers around each
exchange: each rank writes its tensor's bytes once, and reads its peers'
(all of them for ``all_gather``, its own slice of each for
``reduce_scatter``).  A CUDA tensor's bytes pass through a small pinned
host buffer in chunks, so the page cache is the only host copy.  gloo
carries nothing but the barriers.  A transport across hosts or cards
swaps in here alone.

Sums are taken in a fixed order: ``ordered_sum`` gathers every rank's
tensor and adds them in group order (in float32 for a narrower dtype),
so every rank of a group gets the same bits, run after run;
``reduce_scatter`` gives each rank the same bits on its slice alone,
from one all-to-all of the slices (each rank receives a slice from each
peer, where ``ordered_sum`` receives every peer's whole tensor).

The autograd functions carry the collectives of the mesh step
(``train/mesh_step.py``) through the backward pass (the library's
``torch.distributed.nn.functional.all_gather`` would run gloo's own
collectives):

- ``enter`` (Megatron's f): identity forward, gradient summed over the
  group — a replicated input entering rank-partial computation;
- ``leave`` (Megatron's g): forward sum over the group, identity
  backward — rank-partial results made whole on every rank;
- ``weighted_sum``: forward sums weighted per-rank values, backward
  sums the gradient over the group and weights it — a batch statistic
  whose row mean the group's ranks split;
- ``gather_sum``: forward gathers a leaf's shards along a dim (FSDP),
  backward sums the gradient over the group on this rank's slice
  (``reduce_scatter``: each rank saw other data);
- ``gather_slice``: forward gathers the same way, backward keeps this
  rank's slice unsummed (every rank of the group ran the same
  computation on the gathered leaf, so their gradients are equal).

``recording(mesh)`` traces one rank's step without its peers (the dry
run, ``launch/dryrun.py``): inside it a description mesh (a ``rank``, no
process groups) gives ``DescGroup``s, and each collective over one
returns tensors of its output's shape on its input's device, zeros where
a peer's data would be, and records its class, its group size G and its
output bytes.  The classes, by what each op computes (not by how the
file transport moves it):

- ``ordered_sum`` (so ``leave``'s forward, ``enter``'s backward, both
  passes of ``weighted_sum`` and ``gather_sum``'s backward over a whole
  leaf): an all-reduce;
- ``all_gather`` (so the forward of ``gather_sum`` and ``gather_slice``
  along a dim): an all-gather;
- ``reduce_scatter`` (so ``gather_sum``'s backward along a dim): a
  reduce-scatter.

``wire_bytes`` turns a record into the bytes one rank sends, the
reference's formulas (``launch/roofline.py:parse_collectives``).  The
mode is never the default and changes nothing outside it: there a
description mesh's ``group`` raises as before.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

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


class DescGroup:
    """A group of a description mesh under ``recording``: its ranks in
    group order and the caller's rank among them."""

    def __init__(self, ranks: Sequence[int], me: int):
        self.ranks = tuple(int(r) for r in ranks)
        self.index = self.ranks.index(int(me))

    def __repr__(self):
        return f"DescGroup({self.ranks}, index={self.index})"


# the bytes one rank sends for a collective of output ``out`` bytes over
# G ranks (the reference's launch/roofline.py:parse_collectives)
_WIRE = {"all-reduce": lambda g, out: 2 * (g - 1) / g * out,
         "all-gather": lambda g, out: (g - 1) / g * out,
         "reduce-scatter": lambda g, out: (g - 1) * out,
         "all-to-all": lambda g, out: (g - 1) / g * out,
         "collective-permute": lambda g, out: out}
CLASSES = tuple(_WIRE)


def wire_bytes(cls: str, g: int, out_bytes: float) -> float:
    return _WIRE[cls](g, out_bytes)


class Recorder:
    """The collectives of one rank's trace: ``(class, G, output bytes,
    the group's ranks)`` in call order."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.records: List[Tuple[str, int, int, Tuple[int, ...]]] = []

    def note(self, cls: str, group: DescGroup, out_bytes: int) -> None:
        self.records.append((cls, len(group.ranks), int(out_bytes),
                             group.ranks))


def wire_totals(records) -> Dict[str, float]:
    """Wire bytes of ``Recorder.records`` by class, and their
    ``total``."""
    out = {c: 0.0 for c in CLASSES}
    for cls, g, b, _ in records:
        out[cls] += wire_bytes(cls, g, b)
    out["total"] = sum(out.values())
    return out


_RECORDER: Optional[Recorder] = None


def recorder() -> Optional[Recorder]:
    return _RECORDER


@contextlib.contextmanager
def recording(mesh):
    """Collectives over ``mesh``'s description groups stand in for the
    peers and are recorded (module docstring); yields the
    ``Recorder``."""
    global _RECORDER
    prev, _RECORDER = _RECORDER, Recorder(mesh)
    try:
        yield _RECORDER
    finally:
        _RECORDER = prev


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def group_size(group: Group) -> int:
    if isinstance(group, DescGroup):
        return len(group.ranks)
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Group) -> int:
    if isinstance(group, DescGroup):
        return group.index
    return 0 if group is None else dist.get_rank(group)


# the directory the ranks of one host exchange tensors through, and
# each group's count of exchanges so far: every rank of a group makes the
# same exchanges in the same order
_HOST_DIR: Optional[str] = None
_SEQ: Dict[Tuple[int, ...], int] = {}
# the pinned buffer a CUDA tensor's bytes pass through, in chunks of its
# size (allocated at a rank's first CUDA exchange)
_STAGE_BYTES = 64 << 20
_STAGE: Optional[torch.Tensor] = None


def set_host_dir(path: str) -> None:
    """Exchange through files in ``path`` (every rank of the run)."""
    global _HOST_DIR
    os.makedirs(path, exist_ok=True)
    _HOST_DIR = path
    _SEQ.clear()


def _stage() -> torch.Tensor:
    global _STAGE
    if _STAGE is None:
        _STAGE = torch.empty(_STAGE_BYTES, dtype=torch.uint8,
                             pin_memory=True)
    return _STAGE


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def _writeall(f, buf: torch.Tensor) -> None:
    view = memoryview(buf.numpy())
    done = 0
    while done < len(view):
        done += f.write(view[done:])


def _write(path: str, parts: Sequence[torch.Tensor]) -> None:
    """The bytes of ``parts``, one after another, into a new file
    ``path``."""
    with open(path + ".tmp", "wb", buffering=0) as f:
        for p in parts:
            flat = _bytes(p)
            if flat.device.type == "cpu":
                _writeall(f, flat)
                continue
            st = _stage()
            for a in range(0, flat.numel(), _STAGE_BYTES):
                n = min(_STAGE_BYTES, flat.numel() - a)
                st[:n].copy_(flat[a:a + n])
                _writeall(f, st[:n])
    os.replace(path + ".tmp", path)


def _readinto(f, buf: torch.Tensor) -> None:
    view = memoryview(buf.numpy())
    got = 0
    while got < len(view):
        k = f.readinto(view[got:])
        if not k:
            raise EOFError(f"{f.name}: {got} of {len(view)} bytes")
        got += k


def _read(path: str, offset: int, out: torch.Tensor) -> None:
    """``out.numel()`` bytes of file ``path`` from ``offset`` into
    ``out`` (uint8, any device)."""
    with open(path, "rb", buffering=0) as f:
        f.seek(offset)
        if out.device.type == "cpu":
            _readinto(f, out)
            return
        st = _stage()
        for a in range(0, out.numel(), _STAGE_BYTES):
            n = min(_STAGE_BYTES, out.numel() - a)
            _readinto(f, st[:n])
            out[a:a + n].copy_(st[:n])


def _exchange(parts: Sequence[torch.Tensor], group: Group,
              pick: int = 0) -> List[torch.Tensor]:
    """Each rank writes ``parts`` (one shape and dtype for every part on
    every rank) and reads part ``pick`` of every rank's, in group order,
    on the parts' device: ``[x]`` and 0 gather ``x``; one slice a rank
    and the rank's index are an all-to-all."""
    if _HOST_DIR is None:
        raise RuntimeError("comm: no exchange directory; start the ranks "
                           "with sharding.launch.spawn")
    ranks = tuple(dist.get_process_group_ranks(group))
    seq = _SEQ.get(ranks, 0)
    _SEQ[ranks] = seq + 1
    stem = os.path.join(_HOST_DIR, f"{'-'.join(map(str, ranks))}.{seq}.")
    me = dist.get_rank()
    like = parts[pick]
    _write(stem + str(me), parts)
    dist.barrier(group=group)
    count = like.numel() * like.element_size()
    out = []
    for r in ranks:
        if r == me:
            out.append(like.detach().clone(
                memory_format=torch.contiguous_format))
            continue
        got = torch.empty(count, dtype=torch.uint8, device=like.device)
        _read(stem + str(r), pick * count, got)
        out.append(got.view(like.dtype).reshape(like.shape))
    dist.barrier(group=group)
    os.remove(stem + str(me))
    return out


def all_gather(x: torch.Tensor, group: Group) -> List[torch.Tensor]:
    """Every rank's ``x`` (same shape on all), in group order, on
    ``x``'s device."""
    if group is None:
        return [x]
    if isinstance(group, DescGroup):
        _RECORDER.note("all-gather", group, _nbytes(x) * len(group.ranks))
        return [x.detach().clone() if i == group.index
                else torch.zeros_like(x) for i in range(len(group.ranks))]
    t0 = time.perf_counter()
    out = _exchange([x], group)
    _note("all_gather", t0, x.numel() * x.element_size() * len(out))
    return out


def ordered_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of every rank's ``x`` in group order (float32 accumulation
    for narrower floats), the same bits on every rank."""
    if group is None:
        return x
    if isinstance(group, DescGroup):
        _RECORDER.note("all-reduce", group, _nbytes(x))
        return x.detach().clone()
    parts = all_gather(x, group)
    acc_dtype = (torch.float32 if x.is_floating_point()
                 and x.element_size() < 4 else x.dtype)
    acc = parts[0].to(acc_dtype).clone()
    for p in parts[1:]:
        acc += p.to(acc_dtype)
    return acc.to(x.dtype)


def reduce_scatter(x: torch.Tensor, group: Group, dim: int,
                   sizes: Sequence[int]) -> torch.Tensor:
    """This rank's slice (``sizes`` along ``dim``, in group order) of the
    group-order sum of every rank's ``x``: the bits of ``ordered_sum(x)``
    on that slice.  One all-to-all of the slices, each padded to the
    largest."""
    if group is None:
        return x
    r, m = group_rank(group), max(sizes)
    if isinstance(group, DescGroup):
        own = x.detach().narrow(dim, sum(sizes[:r]), sizes[r]).clone(
            memory_format=torch.contiguous_format)
        _RECORDER.note("reduce-scatter", group, _nbytes(own))
        return own
    t0 = time.perf_counter()
    x = x.detach()
    parts, off = [], 0
    for k in sizes:
        part = x.narrow(dim, off, k)
        off += k
        if k < m:
            shape = list(part.shape)
            shape[dim] = m - k
            part = torch.cat([part, part.new_zeros(shape)], dim=dim)
        parts.append(part)
    got = [p.narrow(dim, 0, sizes[r]) for p in _exchange(parts, group, r)]
    _note("all_to_all", t0, sum(p.numel() for p in got) * x.element_size())
    acc_dtype = (torch.float32 if x.is_floating_point()
                 and x.element_size() < 4 else x.dtype)
    acc = got[0].to(acc_dtype).clone()
    for p in got[1:]:
        acc += p.to(acc_dtype)
    return acc.to(x.dtype).contiguous()


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
        if ctx.dim is None:
            return ordered_sum(g.contiguous(), ctx.group), None, None, None
        return (reduce_scatter(g.contiguous(), ctx.group, ctx.dim,
                               ctx.sizes), None, None, None)


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
