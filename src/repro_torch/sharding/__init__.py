"""Rank meshes, partition specs and their collectives (the reference's
``repro.sharding`` over ``torch.distributed``)."""
from repro_torch.sharding.api import (Mesh, NamedSharding,  # noqa: F401
                                      PartitionSpec, current_mesh,
                                      mesh_context, resolve, set_mesh)
