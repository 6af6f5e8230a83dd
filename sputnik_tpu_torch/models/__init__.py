"""The port's modules: SparseLinear, SparseAttention, SparseTransformer,
SparseMoE, and the serving runtime (SparseDecoder, PagedDecoder, SparseLM,
LMServer)."""

from .attention import SparseAttention
from .linear import SparseLinear, sparse_kaiming_values
from .lm import LMServer, SparseLM, apply_repetition_penalty, sample_logits
from .moe import SparseMoE
from .serving import SparseDecoder
from .serving_paged import PagedDecoder
from .transformer import (MLP, SparseCoreAttention, SparseSelfAttention,
                          SparseTransformer, TransformerLayer)

__all__ = ["SparseAttention", "SparseLinear", "MLP", "SparseCoreAttention",
           "SparseSelfAttention", "SparseTransformer", "TransformerLayer",
           "SparseMoE",
           "SparseDecoder", "PagedDecoder", "SparseLM", "LMServer",
           "sample_logits", "apply_repetition_penalty",
           "sparse_kaiming_values"]
