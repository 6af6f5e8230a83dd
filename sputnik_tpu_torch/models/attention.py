"""SparseAttention: multi-head attention with a sparse score matrix
(counterpart of ``sputnik_tpu/models/attention.py``).

Q/K/V/output projections are ``SparseLinear`` layers; the scores are never
dense: SDDMM samples them into the block panel, a panel softmax normalises
them and SpMM applies them to V. The ``b*heads`` replicas run as the
leading replica dimension of one SDDMM and one SpMM launch over the shared
score topology.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops import panel_api as P
from ..topology import SparseTopology
from .linear import SparseLinear

__all__ = ["SparseAttention"]


class SparseAttention(nn.Module):
    """Multi-head attention over a shared sparse score topology.

    Args:
      num_heads, embed_dim: heads and model width (divisible by heads).
      score_topology: ``SparseTopology`` of the ``[seq, seq]`` score mask,
        shared by all heads and batch elements.
      weight_topologies: optional 4-tuple of weight topologies for the
        q/k/v/out projections; full (dense-equivalent) by default.
      generator, device: value init and parameter placement.
    """

    def __init__(self, num_heads: int, embed_dim: int,
                 score_topology: SparseTopology,
                 weight_topologies: Optional[tuple] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.score_topology = score_topology
        self.score_spec = P.PanelSpec(score_topology)
        wts = weight_topologies
        if wts is None:
            full = SparseTopology.from_dense_mask(
                np.ones((embed_dim, embed_dim), np.float32))
            wts = (full, full, full, full)
        kw = dict(generator=generator, device=device)
        self.q_proj = SparseLinear(wts[0], **kw)
        self.k_proj = SparseLinear(wts[1], **kw)
        self.v_proj = SparseLinear(wts[2], **kw)
        self.out_proj = SparseLinear(wts[3], **kw)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def attention(self, q3d, k3d, v3d):
        """SDDMM -> panel softmax -> SpMM on ``[b*heads, s, head_dim]``."""
        spec = self.score_spec
        scores = P.sddmm(spec, q3d, k3d) * (1.0 / math.sqrt(self.head_dim))
        weights = P.sparse_softmax(spec, scores)
        return P.spmm(spec, weights, v3d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``[batch, seq, embed]`` -> ``[batch, seq, embed]``."""
        b, s, _ = x.shape
        t = self.score_topology
        if s != t.m or s != t.n:
            raise ValueError(f"seq {s} != score topology [{t.m}, {t.n}]")
        h, hd = self.num_heads, self.head_dim

        def split_heads(y):  # [b, s, e] -> [b*h, s, hd]
            return y.reshape(b, s, h, hd).transpose(1, 2).reshape(b * h, s, hd)

        q = split_heads(self.q_proj(x))
        k = split_heads(self.k_proj(x))
        v = split_heads(self.v_proj(x))
        ctx = self.attention(q, k, v)                       # [b*h, s, hd]
        ctx = ctx.reshape(b, h, s, hd).transpose(1, 2).reshape(
            b, s, self.embed_dim)
        return self.out_proj(ctx)
