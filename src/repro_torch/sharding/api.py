"""Mesh context, partition specs and shard spans (the reference's
``sharding/api.py`` over ranks instead of XLA devices).

A ``Mesh`` is a grid of ranks with named axes, the reference's
``("data", "model", "expert")``; one process is one rank
(``sharding/launch.py``).  ``Mesh.init_groups`` builds the process groups
every rank of the run enters together: a
``torch.distributed.device_mesh.DeviceMesh`` over the grid (its per-axis
groups) and the groups the mesh step sums over.  A ``PartitionSpec``
names, per tensor dim, the mesh axes that split it; ``resolve`` binds one
to a mesh as a ``NamedSharding``, dropping axis names the mesh lacks as
the reference's ``_filter_axes`` does, so the same spec tables serve 2D
and 3D meshes and no mesh at all.

A dim split over ``w`` ranks splits as GSPMD pads it: shards of
``ceil(n / w)``, the last one short (or empty).  ``NamedSharding.spans``
gives a rank's ``[start, stop)`` per dim, the spans a sharded checkpoint
records.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_state = threading.local()


class PartitionSpec:
    """Per tensor dim: None (whole), an axis name, or a tuple of axis
    names (major first).  Not a tuple, so trees of specs keep them as
    leaves."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return (isinstance(other, PartitionSpec)
                and self.entries == other.entries)

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"PartitionSpec{self.entries!r}"


P = PartitionSpec


class Mesh:
    """A grid of ranks (``devices``, an int array) with named axes.

    ``rank`` is the calling process's rank (None: a description only, as
    the grid math and the tests use it); ``device`` the torch device its
    shards live on."""

    def __init__(self, devices, axis_names: Sequence[str], *,
                 rank: Optional[int] = None, device=None):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        assert self.devices.ndim == len(self.axis_names), \
            (self.devices.shape, self.axis_names)
        self.rank = rank
        self.device = device
        self.device_mesh = None
        self._groups: Dict[Tuple[str, ...], object] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def ranks(self) -> List[int]:
        return [int(r) for r in self.devices.reshape(-1)]

    def coord(self, rank: Optional[int] = None) -> Optional[Dict[str, int]]:
        """{axis: index} of ``rank`` (default: the caller's); None when
        the rank is not in the mesh."""
        rank = self.rank if rank is None else rank
        if rank is None:
            return None
        where = np.argwhere(self.devices == rank)
        if not len(where):
            return None
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    @property
    def member(self) -> bool:
        return self.coord() is not None

    def _all_groups(self, axes: Tuple[str, ...]) -> List[List[int]]:
        keep = [i for i, a in enumerate(self.axis_names) if a in axes]
        rest = [i for i, a in enumerate(self.axis_names) if a not in axes]
        grid = np.transpose(self.devices, rest + keep)
        n = int(np.prod([self.devices.shape[i] for i in keep] or [1]))
        return [[int(r) for r in row] for row in grid.reshape(-1, n)]

    def init_groups(self, combos: Sequence[Tuple[str, ...]] = ()) -> "Mesh":
        """Collective over every rank of the run (members and not): the
        ``DeviceMesh`` over the grid and one process group per subgrid of
        each axis combination in ``combos`` (all ranks create every group
        in the same order, as ``new_group`` needs)."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        self.device_mesh = DeviceMesh(
            "cpu", torch.as_tensor(self.devices), mesh_dim_names=self.axis_names)
        me = self.rank
        for axes in combos:
            axes = tuple(axes)
            for ranks in self._all_groups(axes):
                g = dist.new_group(ranks=ranks, backend="gloo")
                if me in ranks:
                    self._groups[axes] = g
        return self

    def group(self, axes: Sequence[str]):
        """The caller's process group over ``axes`` (None when every such
        axis has width 1 or the caller is outside the mesh; a
        ``comm.DescGroup`` for a mesh without process groups under
        ``comm.recording(self)``)."""
        axes = tuple(a for a in self.axis_names if a in tuple(axes))
        if not self.member or all(self.shape[a] == 1 for a in axes):
            return None
        from repro_torch.sharding import comm

        rec = comm.recorder()
        if (rec is not None and rec.mesh is self
                and self.device_mesh is None and not self._groups):
            # a description mesh traced without its peers
            ranks = next(g for g in self._all_groups(axes)
                         if self.rank in g)
            return comm.DescGroup(ranks, self.rank)
        if len(axes) == 1 and self.device_mesh is not None:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            raise KeyError(f"no process group over {axes}: pass it to "
                           "Mesh.init_groups")
        return self._groups[axes]


def set_mesh(mesh: Optional[Mesh]) -> None:
    _state.mesh = mesh


def current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh: Optional[Mesh]):
    prev = current_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def _filter_axes(mesh: Mesh, entry):
    """Drop axis names that don't exist in the mesh."""
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry if entry in mesh.axis_names else None
    kept = tuple(a for a in entry if a in mesh.axis_names)
    return kept if kept else None


def spec(*entries) -> PartitionSpec:
    return PartitionSpec(*entries)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def chunk_span(n: int, parts: int, index: int) -> Tuple[int, int]:
    """Shard ``index`` of ``parts`` along a dim of ``n``: GSPMD's split,
    ``ceil(n / parts)`` each, the last one short or empty."""
    c = -(-n // parts)
    a = min(index * c, n)
    return a, min(a + c, n)


class NamedSharding:
    """A ``PartitionSpec`` bound to a ``Mesh`` (axes the mesh lacks
    already dropped)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self):
        return f"NamedSharding({self.mesh.shape}, {self.spec})"

    def dim_axes(self, ndim: int) -> List[Tuple[str, ...]]:
        """Per tensor dim, the mesh axes that split it (major first)."""
        entries = list(self.spec) + [None] * (ndim - len(self.spec))
        return [_entry_axes(e) for e in entries[:ndim]]

    def spans(self, shape: Sequence[int],
              rank: Optional[int] = None) -> List[List[int]]:
        """``[start, stop)`` per dim of ``rank``'s shard of a leaf of
        global ``shape``."""
        c = self.mesh.coord(rank)
        sizes = self.mesh.shape
        out = []
        for n, axes in zip(shape, self.dim_axes(len(shape))):
            parts, index = 1, 0
            for a in axes:
                parts *= sizes[a]
                index = index * sizes[a] + c[a]
            out.append(list(chunk_span(int(n), parts, index)))
        return out

    def replica_id(self, rank: Optional[int] = None) -> int:
        """Index of ``rank`` among the ranks holding the same shard (its
        coordinates on the axes the spec does not use): only replica 0
        writes a shard to a checkpoint."""
        c = self.mesh.coord(rank)
        used = {a for e in self.spec for a in _entry_axes(e)}
        rid = 0
        for a in self.mesh.axis_names:
            if a not in used:
                rid = rid * self.mesh.shape[a] + c[a]
        return rid

    def local(self, x, rank: Optional[int] = None):
        """``rank``'s shard of the whole leaf ``x`` (a view)."""
        if not hasattr(x, "shape") or len(x.shape) == 0:
            return x
        sl = tuple(slice(a, b) for a, b in self.spans(x.shape, rank))
        return x[sl]


def resolve(partition_spec: PartitionSpec,
            mesh: Optional[Mesh] = None) -> Optional[NamedSharding]:
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    filtered = PartitionSpec(*(_filter_axes(mesh, e)
                               for e in partition_spec))
    return NamedSharding(mesh, filtered)
