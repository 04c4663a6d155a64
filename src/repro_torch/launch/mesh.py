"""Rank meshes, the reference's ``launch/mesh.py``: the production
meshes (``make_production_mesh``, ``make_mesh_compat``) and small meshes
over a run's ranks (``make_host_mesh``, ``host_device_map``).

A "device" here is a rank: one process a rank (``sharding/launch.py``),
one GPU a rank in production.  The production meshes keep the
reference's shapes, so the dry run and the roofline
(``launch/dryrun.py``, ``launch/roofline.py``) and every parity test
compare the same shards: ``(data=16, model=16)``, 256 GPUs, and
``(pod=2, data=16, model=16)``, 512.  Ranks fill the grid in row-major
order; on 8-GPU nodes (rank r on node r // 8) each ``"model"`` row of 16
consecutive ranks spans two nodes, and each ``"data"`` column takes one
GPU from every other node, so every collective of the mesh step crosses
the node link (``launch/roofline.py`` prices it so).

Defined as functions, so importing this module touches no process
group."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.sharding.api import Mesh


def _world_ranks(ranks: Optional[Sequence[int]]) -> List[int]:
    if ranks is not None:
        return [int(r) for r in ranks]
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    return list(range(n))


def make_mesh_compat(shape: Sequence[int], axis_names) -> Mesh:
    """A description mesh (no caller rank, no process group) of ranks
    0..n-1 in row-major order over ``shape``."""
    n = int(np.prod(shape))
    return Mesh(np.arange(n).reshape(tuple(shape)), axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) = 256 GPUs.
    Multi-pod: (pod=2, data=16, model=16) = 512 GPUs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, expert: int = 0,
                   axis_names=None, *, ranks: Optional[Sequence[int]] = None,
                   rank: Optional[int] = None, device=None) -> Mesh:
    """Small mesh over the run's ranks (default: every rank of the
    process group, in order).  ``expert > 0`` grows a third ``"expert"``
    axis, the 3D (data, model, expert) meshes MoE configs train on; the
    default stays 2D."""
    rs = _world_ranks(ranks)
    if expert:
        assert data * model * expert <= len(rs), (data, model, expert,
                                                  len(rs))
        grid = np.array(rs[: data * model * expert]).reshape(
            data, model, expert)
        return Mesh(grid, axis_names or ("data", "model", "expert"),
                    rank=rank, device=device)
    assert data * model <= len(rs), (data, model, len(rs))
    grid = np.array(rs[: data * model]).reshape(data, model)
    return Mesh(grid, axis_names or ("data", "model"), rank=rank,
                device=device)


def host_device_map(num_hosts: int,
                    devices: Optional[Sequence[int]] = None
                    ) -> Dict[int, List[int]]:
    """Partition the ranks into per-host groups: host i owns a contiguous
    equal slice.  The elastic layer (core/elastic_loop.py) shrinks and
    grows meshes host-group-wise, as a real failure takes out a whole
    host's devices at once."""
    devices = _world_ranks(devices)
    n = len(devices)
    assert num_hosts > 0 and n % num_hosts == 0, (n, num_hosts)
    per = n // num_hosts
    return {h: devices[h * per:(h + 1) * per] for h in range(num_hosts)}
