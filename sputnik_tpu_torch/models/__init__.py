"""The port's modules: SparseLinear, SparseAttention, SparseTransformer, and
the serving runtime (SparseDecoder, SparseLM, LMServer)."""

from .attention import SparseAttention
from .linear import SparseLinear
from .lm import LMServer, SparseLM, apply_repetition_penalty, sample_logits
from .serving import SparseDecoder
from .transformer import (MLP, SparseCoreAttention, SparseSelfAttention,
                          SparseTransformer, TransformerLayer)

__all__ = ["SparseAttention", "SparseLinear", "MLP", "SparseCoreAttention",
           "SparseSelfAttention", "SparseTransformer", "TransformerLayer",
           "SparseDecoder", "SparseLM", "LMServer", "sample_logits",
           "apply_repetition_penalty"]
