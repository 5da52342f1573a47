from phys_autodiff_tpu.parallel.mesh import (
    Z_AXIS,
    make_mesh,
    field_shardings,
    shard_fields,
    replicated,
    scalar_spec,
    vector_spec,
)
from phys_autodiff_tpu.parallel.sharded import (
    residuals_sharded,
    residuals_halo_sharded,
    loss_forward_halo_sharded,
    make_sharded_train_step,
    make_sharded_fused_train_step,
    make_sharded_train_step_2d,
    make_generic_sharded_train_step,
)

__all__ = [
    "Z_AXIS",
    "make_mesh",
    "field_shardings",
    "shard_fields",
    "replicated",
    "scalar_spec",
    "vector_spec",
    "residuals_sharded",
    "residuals_halo_sharded",
    "loss_forward_halo_sharded",
    "make_sharded_train_step",
    "make_sharded_fused_train_step",
    "make_sharded_train_step_2d",
    "make_generic_sharded_train_step",
]
