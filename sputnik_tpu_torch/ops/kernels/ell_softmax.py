"""Sparse softmax: the CUDA kernel's wrapper and its plain PyTorch versions.

Replaces ``sputnik_tpu/ops/pallas/ell_softmax.py:ell_softmax_panel``; the
kernel is ``csrc/ell_softmax.cu``. It softmaxes each CSR row of
``values [R, nnz_pad]`` in place of the TPU kernel's row-padded ELL panel:
the row max is clamped at -1e30 and the denominator at f32 ``tiny``, so a
row with no slot, or with only ``-inf`` scores, gives zeros; the padding
slots ``nnz..nnz_pad`` are 0.

Two plain versions stand beside it: :func:`ell_softmax_panel` is the TPU
kernel's own contract (an ``[m_pad, l_pad]`` ELL panel and its mask), and
``plain_ops.sparse_softmax`` the wrapper's on the CSR rows (what it runs on
a CPU tensor).
"""

from __future__ import annotations

import torch

from .. import plain_ops
from . import check_operands, guard_no_grad
from ._build import check, library

__all__ = ["ell_softmax_kernel", "ell_softmax_panel"]

_NEG_LARGE = -1e30
_TINY = torch.finfo(torch.float32).tiny


def ell_softmax_panel(panel, mask):
    """Masked row softmax on an ELL panel ``[m_pad, l_pad]`` where ``mask``
    (same shape) is nonzero: the TPU kernel's function, in plain PyTorch."""
    live = mask != 0
    v = torch.where(live, panel, _NEG_LARGE)
    row_max = v.amax(dim=1, keepdim=True).clamp(min=_NEG_LARGE)
    e = torch.where(live, torch.exp(v - row_max), 0.0)
    return e / e.sum(dim=1, keepdim=True).clamp(min=_TINY)


def ell_softmax_kernel(row_offsets, row_ids, values, *, nnz: int):
    """Row softmax over each CSR row, for every replica: ``row_offsets
    i32[m + 1]`` (``row_offsets[m] == nnz``), ``values f32[R, nnz_pad]`` ->
    ``f32[R, nnz_pad]``, 0 at ``nnz..nnz_pad``. ``row_ids int64[nnz_pad]``
    (padding slots -> ``m``, as ``PanelSpec.flat_meta`` holds them) are the
    plain version's segments; the kernel walks ``row_offsets``."""
    if values.dim() != 2 or row_offsets.dim() != 1:
        raise ValueError(f"values must be rank 2 and row_offsets rank 1, got "
                         f"{tuple(values.shape)} and "
                         f"{tuple(row_offsets.shape)}")
    R, nnz_pad = values.shape
    m = row_offsets.numel() - 1
    if not 0 <= nnz <= nnz_pad:
        raise ValueError(f"nnz {nnz} outside [0, {nnz_pad}]")
    if not values.is_cuda:
        return plain_ops.sparse_softmax(values, row_ids, row_ids < m, m)

    guard_no_grad("ell_softmax", "ops.api.sparse_softmax", values)
    dev = values.device
    check_operands("ell_softmax", dev, row_offsets=(row_offsets, torch.int32),
                   values=(values, torch.float32))
    out = torch.empty_like(values)
    if out.numel() == 0:
        return out
    err = library().ell_softmax_f32(
        row_offsets.data_ptr(), values.data_ptr(), out.data_ptr(), R, m, nnz,
        nnz_pad, torch.cuda.current_stream(dev).cuda_stream)
    check(err, "ell_softmax")
    ell_softmax_kernel.launches += 1
    return out


ell_softmax_kernel.launches = 0
