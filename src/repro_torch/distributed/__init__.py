"""Mesh rules and the tensor-parallel context (port of repro.distributed)."""

from repro_torch.distributed.sharding import (  # noqa: F401
    DEFAULT_MESH_RULES,
    MeshRules,
    TensorParallel,
    active_tp,
    logical_to_spec,
    partition_specs,
    placements,
    tensor_parallel,
)
