"""Parallelism on ``torch.distributed``: the mesh, the logical-axis rules and
the collectives (``comm``). The JAX package's names, less ``pathways`` (a
TPU single-controller runtime with no counterpart on an H100)."""

from maxtext_indextts2_tpu_torch.parallel.mesh import (
    Mesh,
    create_device_mesh,
    current_mesh,
    maybe_initialize_distributed,
    mesh_shape_summary,
)
from maxtext_indextts2_tpu_torch.parallel.sharding import (
    LOGICAL_AXIS_RULES,
    assert_params_sufficiently_sharded,
    logical_to_mesh_axes,
    logical_to_placements,
    resolve,
    shard,
)
