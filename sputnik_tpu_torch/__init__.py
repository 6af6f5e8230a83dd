"""sputnik_tpu_torch — the sparse linear-algebra framework in PyTorch, with
hand-written CUDA kernels for Hopper (H100).

The port of ``sputnik_tpu`` (JAX/Pallas on TPU), which stays the reference
it is checked against. Host structure (topologies, block views, masks) is
numpy; values and activations are ``torch`` tensors. CUDA tensors run the
kernels under ``csrc/`` (built with ``nvcc`` at first use); CPU tensors run
each kernel's plain PyTorch version. This package never imports JAX.
"""

from . import bridge, models, ops, patterns
from .blocking import BlockView, build_blocks, stack_block_meta
from .many_mask import (
    ManyMaskTopology,
    csr_transpose_many_mask,
    sddmm_many_mask,
    sparse_softmax_many_mask,
    spmm_many_mask,
)
from .models import (LMServer, SparseAttention, SparseDecoder, SparseLinear,
                     SparseLM, SparseTransformer, sample_logits)
from .ops import (KVCache, PanelSpec, append_kv, append_kv_seq,
                  decode_attention, decode_block_table, fused_sparse_attention,
                  init_kv_cache, insert_kv_slot, prefill_kv,
                  table_from_topology_row)
from .ops.batched_panel import BatchedPanelSpec
from .topology import SparseMatrix, SparseTopology, diffsort

__version__ = "0.1.0"

__all__ = [
    "BatchedPanelSpec",
    "BlockView",
    "KVCache",
    "LMServer",
    "ManyMaskTopology",
    "PanelSpec",
    "SparseAttention",
    "SparseDecoder",
    "SparseLM",
    "SparseLinear",
    "SparseMatrix",
    "SparseTopology",
    "SparseTransformer",
    "append_kv",
    "append_kv_seq",
    "bridge",
    "build_blocks",
    "csr_transpose_many_mask",
    "decode_attention",
    "decode_block_table",
    "diffsort",
    "fused_sparse_attention",
    "init_kv_cache",
    "insert_kv_slot",
    "models",
    "ops",
    "patterns",
    "prefill_kv",
    "sample_logits",
    "sddmm_many_mask",
    "sparse_softmax_many_mask",
    "spmm_many_mask",
    "stack_block_meta",
    "table_from_topology_row",
]
