"""Panel SDDMM: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``sputnik_tpu/ops/pallas/bsr_sddmm.py:bsr_sddmm_panel``; the kernel
is ``csrc/bsr_sddmm.cu``. ``lhs [R, M, D] x rhs [R, Nr, D]`` sampled at the
occupied tiles of one shared topology into panels
``[R, mb, max_bpr, bm, bk]``; padded slots and masked elements are exactly 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import check_operands, guard_no_grad
from ._build import check, library

__all__ = ["bsr_sddmm_panel", "bsr_sddmm_panel_plain"]


def bsr_sddmm_panel_plain(block_cols, nblocks, lhs, rhs, mask):
    """Plain version: gather each slot's rhs tile, one batched product."""
    mb, max_bpr, bm, bk = mask.shape
    R, M, D = lhs.shape
    Nr = rhs.shape[1]
    kb = max(-(-Nr // bk), 1)
    lhs_t = F.pad(lhs, (0, 0, 0, mb * bm - M)).view(R, mb, bm, D)
    rhs_t = F.pad(rhs, (0, 0, 0, kb * bk - Nr)).view(R, kb, bk, D)
    cols = block_cols.view(mb, max_bpr).long()
    prod = torch.einsum("rimd,riskd->rismk", lhs_t, rhs_t[:, cols])
    live = (torch.arange(max_bpr, device=mask.device)[None, :]
            < nblocks.long()[:, None])                      # [mb, max_bpr]
    keep = (mask != 0) & live[:, :, None, None]
    return torch.where(keep, prod * mask, 0.0)


def bsr_sddmm_panel(block_cols, nblocks, lhs, rhs, mask):
    """block_cols i32[mb * max_bpr], nblocks i32[mb], lhs f32[R, M, D]
    (M <= mb * bm), rhs f32[R, Nr, D], mask f32[mb, max_bpr, bm, bk]
    -> f32[R, mb, max_bpr, bm, bk]."""
    if lhs.dim() != 3 or rhs.dim() != 3 or mask.dim() != 4:
        raise ValueError("lhs and rhs must be rank 3 and mask rank 4")
    mb, max_bpr, bm, bk = mask.shape
    R, M, D = lhs.shape
    if rhs.shape[0] != R or rhs.shape[2] != D:
        raise ValueError(f"rhs {tuple(rhs.shape)} does not match lhs "
                         f"{tuple(lhs.shape)}")
    if M > mb * bm:
        raise ValueError(f"lhs has {M} rows, the panel {mb * bm}")
    if not lhs.is_cuda:
        return bsr_sddmm_panel_plain(block_cols, nblocks, lhs, rhs, mask)

    guard_no_grad("bsr_sddmm_panel", "panel_api.sddmm", lhs, rhs)
    dev = lhs.device
    check_operands("bsr_sddmm_panel", dev,
                   block_cols=(block_cols, torch.int32),
                   nblocks=(nblocks, torch.int32),
                   lhs=(lhs, torch.float32), rhs=(rhs, torch.float32),
                   mask=(mask, torch.float32))
    if block_cols.numel() != mb * max_bpr or nblocks.numel() != mb:
        raise ValueError("block metadata does not match the mask shape")
    if R > 65535 or mb * max_bpr > 65535:
        raise ValueError("grid too large for one launch")
    out = torch.empty((R, mb, max_bpr, bm, bk), device=dev,
                      dtype=torch.float32)
    if out.numel() == 0:
        return out
    err = library().sddmm_panel_f32(
        block_cols.data_ptr(), nblocks.data_ptr(), lhs.data_ptr(),
        rhs.data_ptr(), mask.data_ptr(), out.data_ptr(), R, mb, max_bpr, bm,
        bk, M, rhs.shape[1], D, torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bsr_sddmm_panel")
    bsr_sddmm_panel.launches += 1
    return out


bsr_sddmm_panel.launches = 0
