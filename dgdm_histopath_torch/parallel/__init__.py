"""Data parallelism over ``torch.distributed``: the mesh, batch sharding and
the explicit-collective train step. Tensor, sequence, pipeline and expert
parallelism are not ported yet (ROADMAP queue 1, item 12)."""

from .mesh import (
    DATA_AXIS,
    Mesh,
    make_mesh,
    pad_batch_to_devices,
    replicate_tree,
    shard_batch,
)
from .spmd_step import hierarchical_pmean, make_spmd_train_step

__all__ = ["DATA_AXIS", "Mesh", "hierarchical_pmean", "make_mesh",
           "make_spmd_train_step", "pad_batch_to_devices", "replicate_tree", "shard_batch"]
