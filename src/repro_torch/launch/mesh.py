"""Small rank meshes (the reference's ``launch/mesh.py``:
``make_host_mesh`` and ``host_device_map``; its production meshes and
``make_mesh_compat`` are ROADMAP item 13).

A "device" here is a rank: one process a rank (``sharding/launch.py``).
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
