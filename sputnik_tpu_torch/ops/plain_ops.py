"""Plain PyTorch versions of the flat CSR ops (counterpart of
``sputnik_tpu/ops/xla_ops.py``).

Gather + segment-reduction formulations on the padding conventions of
``topology.py`` (padding slots carry row id ``m`` and are parked in a dump
segment that is sliced away). They are the port's oracle for the flat API
and the many-mask path; autograd differentiates them as they stand.

  * ``spmm``   : A_sp[m, k] @ B[k, n]
  * ``sddmm``  : (L[m, d] @ R[n, d]^T) sampled at the nonzeros
  * ``sparse_softmax``: row-wise over the nonzeros of each CSR row
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["spmm", "sddmm", "sparse_softmax"]

_NEG_LARGE = -1e30


def _idx(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.int64, device=device)


def spmm(values, col_ids, row_ids, m: int, dense):
    """CSR sparse ``[m, k]`` times dense ``[k, n]`` -> dense ``[m, n]``."""
    ci, ri = _idx(col_ids, dense.device), _idx(row_ids, dense.device)
    contrib = dense.index_select(0, ci) * values[:, None]
    out = dense.new_zeros((m + 1, dense.shape[1]))
    out = out.index_add(0, ri, contrib.to(out.dtype))
    return out[:m]


def sddmm(lhs, rhs, row_ids, col_ids, valid):
    """Sampled dense-dense: ``out[e] = <lhs[row[e]], rhs[col[e]]>``; padding
    slots give exactly 0."""
    dev = lhs.device
    ri = _idx(row_ids, dev).clamp(max=lhs.shape[0] - 1)
    ci = _idx(col_ids, dev)
    vals = (lhs.index_select(0, ri) * rhs.index_select(0, ci)).sum(-1)
    va = torch.as_tensor(np.asarray(valid), device=dev)
    return torch.where(va, vals, torch.zeros_like(vals))


def sparse_softmax(values, row_ids, valid, m: int):
    """Row-wise softmax over the nonzeros of each CSR row; empty rows have
    no slots, padding slots give 0."""
    dev = values.device
    ri = _idx(row_ids, dev)
    va = torch.as_tensor(np.asarray(valid), device=dev)
    vm = torch.where(va, values, torch.full_like(values, _NEG_LARGE))
    row_max = torch.full((m + 1,), _NEG_LARGE, dtype=values.dtype,
                         device=dev)
    row_max = row_max.scatter_reduce(0, ri, vm, reduce="amax",
                                     include_self=True)
    e = torch.exp(vm - row_max[ri])
    e = torch.where(va, e, torch.zeros_like(e))
    denom = values.new_zeros((m + 1,)).index_add(0, ri, e)
    denom = denom.clamp(min=torch.finfo(values.dtype).tiny)
    return e / denom[ri]
