"""Training-time sparsity tooling: dynamic sparse training (counterpart of
``sputnik_tpu/training``)."""

from .sparsity import (
    block_occupancy,
    block_rigl_update,
    cubic_sparsity_schedule,
    dense_linear_grad,
    magnitude_prune,
    remap_values,
    rigl_update,
    rigl_update_linear,
    rigl_update_moe,
    topology_from_dense,
)

__all__ = [
    "block_occupancy",
    "block_rigl_update",
    "cubic_sparsity_schedule",
    "dense_linear_grad",
    "magnitude_prune",
    "remap_values",
    "rigl_update",
    "rigl_update_linear",
    "rigl_update_moe",
    "topology_from_dense",
]
