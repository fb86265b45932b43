"""Parallel layer of the port: the six-axis device mesh, the logical
sharding rules as DTensor placements, ring and Ulysses attention over the
"seq" axis, the GPipe loop over "stage", the MoE layer with its "expert"
axis, and the multi-rank dry run. Counterpart of ``ray_tpu/parallel``.
``ring_attention`` and ``ulysses_attention`` are imported from
``parallel.ring_attention``: a package-level function of that name would
hide the module."""
from ray_tpu_torch.parallel.mesh import (
    AXES,
    MeshConfig,
    make_mesh,
    mesh_shape,
    single_device_mesh,
)
from ray_tpu_torch.parallel.moe import (
    MoEConfig,
    init_moe_params,
    moe_layer,
    moe_param_axes,
)
from ray_tpu_torch.parallel.pipeline import pipeline_apply
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    named_sharding,
    replicated,
    shard_batch_spec,
    spec_from_logical,
    tree_shardings,
    with_sharding_constraint,
)

__all__ = [
    "AXES", "DEFAULT_RULES", "MeshConfig", "MoEConfig", "init_moe_params",
    "make_mesh", "mesh_shape", "moe_layer", "moe_param_axes", "named_sharding",
    "pipeline_apply", "replicated", "shard_batch_spec", "single_device_mesh",
    "spec_from_logical", "tree_shardings", "with_sharding_constraint",
]
