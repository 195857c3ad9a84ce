"""Sharding rules and the mesh context (port of ``repro.sharding``)."""

from repro_torch.sharding.ctx import (
    MeshContext,
    use_mesh,
    current_mesh_context,
    shard_activation,
    batch_axes,
    manual_axes,
    pvary_manual,
)
from repro_torch.sharding.specs import (P, AbstractMesh, param_specs, input_specs_sharding,
                                        batch_spec, replicated, to_placements)

__all__ = [
    "MeshContext",
    "use_mesh",
    "current_mesh_context",
    "shard_activation",
    "batch_axes",
    "manual_axes",
    "pvary_manual",
    "P",
    "AbstractMesh",
    "param_specs",
    "input_specs_sharding",
    "batch_spec",
    "replicated",
    "to_placements",
]
