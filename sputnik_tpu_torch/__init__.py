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
from .models import SparseAttention, SparseLinear, SparseTransformer
from .ops import PanelSpec, fused_sparse_attention
from .ops.batched_panel import BatchedPanelSpec
from .topology import SparseMatrix, SparseTopology, diffsort

__version__ = "0.1.0"

__all__ = [
    "BatchedPanelSpec",
    "BlockView",
    "ManyMaskTopology",
    "PanelSpec",
    "SparseAttention",
    "SparseLinear",
    "SparseMatrix",
    "SparseTopology",
    "SparseTransformer",
    "bridge",
    "build_blocks",
    "csr_transpose_many_mask",
    "diffsort",
    "fused_sparse_attention",
    "models",
    "ops",
    "patterns",
    "sddmm_many_mask",
    "sparse_softmax_many_mask",
    "spmm_many_mask",
    "stack_block_meta",
]
