"""sputnik_tpu_torch — the sparse linear-algebra framework in PyTorch, with
hand-written CUDA kernels for Hopper (H100).

The port of ``sputnik_tpu`` (JAX/Pallas on TPU), which stays the reference
it is checked against. Host structure (topologies, block views, masks) is
numpy; values and activations are ``torch`` tensors. CUDA tensors run the
kernels under ``csrc/`` (built with ``nvcc`` at first use); CPU tensors run
each kernel's plain PyTorch version. The flat op set (``spmm``,
``left_spmm``, ``sddmm``, ``sparse_softmax``, ``csr_transpose``,
``spmm_bias_relu``) keeps the reference's CSR-ordered values and the JAX
package's ``set_backend`` names; ``int8`` is the W8A8 serving family;
``PanelSpec(..., compressed=True)`` runs the panel ops on the true-BSR
layout (``CompressedView``); ``parallel`` holds the row partition,
sequence-parallel ring flash attention and the halo SpMM. This package
never imports JAX.
"""

from . import bridge, models, ops, parallel, patterns, training
from .blocking import (BlockView, CompressedView, EllView, build_blocks,
                       build_compressed, stack_block_meta)
from .many_mask import (
    ManyMaskTopology,
    csr_transpose_many_mask,
    sddmm_many_mask,
    sparse_softmax_many_mask,
    spmm_many_mask,
)
from .models import (LMServer, PagedDecoder, SparseAttention, SparseDecoder,
                     SparseLinear, SparseLM, SparseMoE, SparseTransformer,
                     sample_logits)
from .ops import (KVCache, PagedKVCache, PagePool, PanelSpec, append_kv,
                  append_kv_seq, append_paged, append_paged_seq,
                  csr_transpose, decode, decode_attention, decode_block_table,
                  ensure_pages, free_pages_of, fused_sparse_attention,
                  get_backend, init_kv_cache, init_paged_cache, int8,
                  insert_kv_slot, left_spmm, paged_attention,
                  paged_block_table, panel, prefill_kv, sddmm, set_backend,
                  share_prefix, sparse_softmax, spmm, spmm_bias,
                  spmm_bias_relu, table_from_topology_row,
                  write_prompt_pages)
from .ops.batched_panel import (BatchedPanelSpec, sddmm_bh, sparse_softmax_bh,
                                spmm_bh)
from .topology import SparseMatrix, SparseTopology, diffsort

__version__ = "0.1.0"

__all__ = [
    "BatchedPanelSpec",
    "BlockView",
    "CompressedView",
    "EllView",
    "KVCache",
    "LMServer",
    "ManyMaskTopology",
    "PagePool",
    "PagedDecoder",
    "PagedKVCache",
    "PanelSpec",
    "SparseAttention",
    "SparseDecoder",
    "SparseLM",
    "SparseLinear",
    "SparseMatrix",
    "SparseMoE",
    "SparseTopology",
    "SparseTransformer",
    "append_kv",
    "append_kv_seq",
    "append_paged",
    "append_paged_seq",
    "bridge",
    "build_blocks",
    "build_compressed",
    "csr_transpose",
    "csr_transpose_many_mask",
    "decode",
    "decode_attention",
    "decode_block_table",
    "diffsort",
    "ensure_pages",
    "free_pages_of",
    "fused_sparse_attention",
    "get_backend",
    "init_kv_cache",
    "init_paged_cache",
    "insert_kv_slot",
    "int8",
    "left_spmm",
    "models",
    "ops",
    "paged_attention",
    "paged_block_table",
    "panel",
    "parallel",
    "patterns",
    "prefill_kv",
    "sample_logits",
    "sddmm",
    "sddmm_bh",
    "sddmm_many_mask",
    "set_backend",
    "share_prefix",
    "sparse_softmax",
    "sparse_softmax_bh",
    "sparse_softmax_many_mask",
    "spmm",
    "spmm_bh",
    "spmm_bias",
    "spmm_bias_relu",
    "spmm_many_mask",
    "stack_block_meta",
    "table_from_topology_row",
    "training",
    "write_prompt_pages",
]
