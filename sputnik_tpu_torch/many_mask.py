"""Many-mask (ragged batched) topology and its forward ops.

Counterpart of ``sputnik_tpu/many_mask.py``: ``b`` per-batch-element masks
over one ``m x n`` shape, each mask's CSR padded to the shared ``nnz_pad``,
and ``R = b*h`` operand replicas where the ``h`` heads of a batch element
share its mask (replica ``r`` uses mask ``r // h``).

The ops are plain PyTorch over ``ops/plain_ops.py``. They are the oracle
the kernel paths are checked against, not kernels.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .ops import plain_ops
from .topology import DEFAULT_PAD_TO, SparseTopology, _round_up

__all__ = [
    "ManyMaskTopology",
    "spmm_many_mask",
    "sddmm_many_mask",
    "sparse_softmax_many_mask",
    "csr_transpose_many_mask",
]


class ManyMaskTopology:
    """A batch of ``b`` sparsity patterns over a shared ``m x n`` shape,
    stacked with a shared ``nnz_pad`` bucket."""

    def __init__(self, topologies: List[SparseTopology],
                 pad_to: Optional[int] = None):
        if not topologies:
            raise ValueError("need at least one mask")
        m, n = topologies[0].m, topologies[0].n
        for t in topologies:
            if (t.m, t.n) != (m, n):
                raise ValueError("masks must share [m, n]")
        self.b = len(topologies)
        self.m, self.n = m, n
        self.nnzs = np.array([t.nnz for t in topologies], dtype=np.int32)
        self.nnz_pad = _round_up(int(self.nnzs.max(initial=1)),
                                 pad_to or DEFAULT_PAD_TO)

        def pad_slot(t, arr, fill):
            out = np.full(self.nnz_pad, fill, dtype=arr.dtype)
            out[: min(t.nnz, self.nnz_pad)] = arr[: t.nnz]
            return out

        self.column_indices = np.stack(
            [pad_slot(t, t.column_indices, 0) for t in topologies])
        self.row_ids = np.stack([pad_slot(t, t.row_ids, m)
                                 for t in topologies])
        self.valid = np.stack([np.arange(self.nnz_pad) < t.nnz
                               for t in topologies])
        self.row_offsets = np.stack([t.row_offsets for t in topologies])
        self.row_swizzle = np.stack([t.row_swizzle for t in topologies])
        self.topologies = list(topologies)
        self._transpose_cache = None

    @classmethod
    def from_dense_masks(cls, masks: np.ndarray,
                         pad_to: Optional[int] = None) -> "ManyMaskTopology":
        """masks: ``[b, m, n]`` 0/1, converted to CSR once."""
        masks = np.asarray(masks)
        if masks.ndim != 3:
            raise ValueError(f"expected [b, m, n] masks, got {masks.shape}")
        return cls([SparseTopology.from_dense_mask(mk) for mk in masks],
                   pad_to=pad_to)

    def __repr__(self):
        return (f"ManyMaskTopology(b={self.b}, m={self.m}, n={self.n}, "
                f"nnzs={self.nnzs.tolist()}, nnz_pad={self.nnz_pad})")

    def transpose(self) -> Tuple["ManyMaskTopology", np.ndarray]:
        """Transposed batch topology + stacked value permutation
        ``[b, nnz_pad]``."""
        if self._transpose_cache is not None:
            return self._transpose_cache
        topo_ts, perms = [], []
        for t in self.topologies:
            tt, perm = t.transpose()
            topo_ts.append(tt)
            perms.append(perm)
        mt_t = ManyMaskTopology(topo_ts)

        def rebucket(perms_list, src_pad, dst_pad):
            out = np.zeros((self.b, dst_pad), dtype=np.int32)
            for i, (t, perm) in enumerate(zip(self.topologies, perms_list)):
                p = np.minimum(perm, src_pad - 1)
                take = min(len(p), dst_pad)
                out[i] = min(t.nnz, src_pad - 1)
                out[i, :take] = p[:take]
            return out

        perm_stack = rebucket(perms, self.nnz_pad, mt_t.nnz_pad)
        inv_list = [tt.transpose()[1] for tt in topo_ts]
        inv_stack = rebucket(inv_list, mt_t.nnz_pad, self.nnz_pad)
        mt_t._transpose_cache = (self, inv_stack)
        self._transpose_cache = (mt_t, perm_stack)
        return self._transpose_cache


def _heads(mt, x) -> int:
    r = x.shape[0]
    if r % mt.b:
        raise ValueError(f"replica dim {r} not a multiple of b={mt.b}")
    return r // mt.b


def spmm_many_mask(mt, values, dense):
    """``values [R, nnz_pad] x dense [R, k, n] -> [R, m, n]``."""
    h = _heads(mt, values)
    return torch.stack([
        plain_ops.spmm(values[r], mt.column_indices[r // h],
                       mt.row_ids[r // h], mt.m, dense[r])
        for r in range(values.shape[0])])


def sddmm_many_mask(mt, lhs, rhs):
    """``lhs [R, m, d] x rhs [R, n, d] -> values [R, nnz_pad]``."""
    h = _heads(mt, lhs)
    return torch.stack([
        plain_ops.sddmm(lhs[r], rhs[r], mt.row_ids[r // h],
                        mt.column_indices[r // h], mt.valid[r // h])
        for r in range(lhs.shape[0])])


def sparse_softmax_many_mask(mt, values):
    """Ragged row softmax per mask: ``[R, nnz_pad] -> [R, nnz_pad]``."""
    h = _heads(mt, values)
    return torch.stack([
        plain_ops.sparse_softmax(values[r], mt.row_ids[r // h],
                                 mt.valid[r // h], mt.m)
        for r in range(values.shape[0])])


def csr_transpose_many_mask(mt, values):
    """Per-mask CSR transpose of replicated values -> ``(mt_t, values_t)``."""
    h = _heads(mt, values)
    mt_t, perm = mt.transpose()
    idx = torch.as_tensor(perm, dtype=torch.int64, device=values.device)
    out = torch.stack([values[r].index_select(0, idx[r // h])
                       for r in range(values.shape[0])])
    return mt_t, out
