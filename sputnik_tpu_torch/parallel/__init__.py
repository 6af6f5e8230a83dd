"""The distribution layer (counterpart of ``sputnik_tpu/parallel``): the
row partition, the sharded panel ops (ELL and compressed), sequence-
parallel flash attention (K / V replicated, key-sharded with a halo
exchange, or rotating in a ring), and the communication model.

The JAX package runs them over a device mesh under ``shard_map``; here the
shards of a stacked ``[ndev, ...]`` operand run on its one device, each
shard's work written as a rank-local step and every exchange routed
through ``_mesh``. Putting the shards on separate cards, and the pipeline
and tensor-parallel serving layers, are ``ROADMAP.md`` A9c.
"""

from . import comm_model
from .flash_sharded import (ShardedFlashSpec, flash_attention_kv_sharded,
                            flash_attention_sharded)
from .partition import RowPartition
from .ring_flash import RingFlashSpec, ring_flash_attention
from .sharded_compressed import (ShardedCompressedSpec, sharded_sddmm_c,
                                 sharded_softmax_c, sharded_spmm_c,
                                 sharded_spmm_t_c,
                                 sparse_attention_sharded_c)
from .sharded_ops import (ShardedPanelSpec, sharded_sddmm, sharded_softmax,
                          sharded_spmm, sharded_spmm_halo, sharded_spmm_t,
                          sparse_attention_sharded)

__all__ = [
    "RingFlashSpec",
    "RowPartition",
    "ShardedCompressedSpec",
    "ShardedFlashSpec",
    "ShardedPanelSpec",
    "comm_model",
    "flash_attention_kv_sharded",
    "flash_attention_sharded",
    "ring_flash_attention",
    "sharded_sddmm",
    "sharded_sddmm_c",
    "sharded_softmax",
    "sharded_softmax_c",
    "sharded_spmm",
    "sharded_spmm_c",
    "sharded_spmm_halo",
    "sharded_spmm_t",
    "sharded_spmm_t_c",
    "sparse_attention_sharded",
    "sparse_attention_sharded_c",
]
