"""The port's modules: SparseLinear, SparseAttention, SparseTransformer."""

from .attention import SparseAttention
from .linear import SparseLinear
from .transformer import (MLP, SparseCoreAttention, SparseSelfAttention,
                          SparseTransformer, TransformerLayer)

__all__ = ["SparseAttention", "SparseLinear", "MLP", "SparseCoreAttention",
           "SparseSelfAttention", "SparseTransformer", "TransformerLayer"]
