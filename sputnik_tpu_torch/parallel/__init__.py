"""The distribution layer (counterpart of ``sputnik_tpu/parallel``): the
row partition, sequence-parallel ring flash attention and the halo SpMM.

The JAX package runs them over a device mesh under ``shard_map``; here the
shards of a stacked ``[ndev, ...]`` operand run on its one device, each
shard's work written as a rank-local step and every exchange routed
through ``_mesh`` (``ROADMAP.md`` A9c puts them on separate cards). The
rest of JAX's ``parallel`` package is ``ROADMAP.md`` A9b and A9c.
"""

from .partition import RowPartition
from .ring_flash import RingFlashSpec, ring_flash_attention
from .sharded_ops import ShardedPanelSpec, sharded_spmm_halo

__all__ = [
    "RingFlashSpec",
    "RowPartition",
    "ShardedPanelSpec",
    "ring_flash_attention",
    "sharded_spmm_halo",
]
