"""The distribution layer (counterpart of ``sputnik_tpu/parallel``): the
mesh (``Mesh``: named axes on one device or one position a
``torch.distributed`` rank, with differentiable collectives), tensor /
data-parallel serving (``TPDecoder``, ``PagedTPDecoder``, ``TPLMServer``),
the GPipe pipeline (``PipelineSpec``, ``pipeline_apply``,
``stack_stage_params``), the row partition, the sharded panel ops (ELL and
compressed), sequence-parallel flash attention (K / V replicated,
key-sharded with a halo exchange, or rotating in a ring), and the
communication model. Expert parallelism is ``models.SparseMoE(mesh=)``.

The JAX package runs them over a device mesh under ``shard_map``. Here
serving, the pipeline and expert parallelism run over a ``Mesh``; the
sequence-parallel layer runs the shards of a stacked ``[ndev, ...]``
operand on its one device, each shard's work written as a rank-local step
and every exchange routed through ``_mesh``. Putting those specs on ranks
is the sequence-parallel half of ``ROADMAP.md`` A9d.
"""

from . import comm_model
from ._mesh import Mesh
from .flash_sharded import (ShardedFlashSpec, flash_attention_kv_sharded,
                            flash_attention_sharded)
from .lm_tp import TPLMServer
from .partition import RowPartition
from .pipeline import PipelineSpec, pipeline_apply, stack_stage_params
from .ring_flash import RingFlashSpec, ring_flash_attention
from .sharded_compressed import (ShardedCompressedSpec, sharded_sddmm_c,
                                 sharded_softmax_c, sharded_spmm_c,
                                 sharded_spmm_t_c,
                                 sparse_attention_sharded_c)
from .serving_tp import PagedTPDecoder, TPDecoder
from .sharded_ops import (ShardedPanelSpec, sharded_sddmm, sharded_softmax,
                          sharded_spmm, sharded_spmm_halo, sharded_spmm_t,
                          sparse_attention_sharded)

__all__ = [
    "Mesh",
    "PagedTPDecoder",
    "PipelineSpec",
    "RingFlashSpec",
    "RowPartition",
    "ShardedCompressedSpec",
    "ShardedFlashSpec",
    "ShardedPanelSpec",
    "TPDecoder",
    "TPLMServer",
    "comm_model",
    "flash_attention_kv_sharded",
    "flash_attention_sharded",
    "pipeline_apply",
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
    "stack_stage_params",
]
