"""Panel SpMM: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``sputnik_tpu/ops/pallas/bsr_spmm.py:bsr_spmm_panel``; the kernel
is ``csrc/bsr_spmm.cu``. The sparse operand is the block panel
``[R, mb, max_bpr, bm, bk]`` over ONE topology shared by the ``R``
replicas; ``dense`` is ``[R, K, N]`` and the result ``[R, rows, N]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import check_operands, guard_no_grad
from ._build import check, library

__all__ = ["bsr_spmm_panel", "bsr_spmm_panel_plain", "EPILOGUES"]

EPILOGUES = {"none": 0, "bias": 1, "bias_relu": 2}


def _epilogue(out, bias, epilogue):
    if epilogue == "none":
        return out
    out = out + bias[:, None]
    return torch.relu(out) if epilogue == "bias_relu" else out


def bsr_spmm_panel_plain(block_cols, nblocks, panel, dense, bias=None, *,
                         rows: int, epilogue: str = "none"):
    """Plain version: one batched product per block slot, padded slots
    (``s >= nblocks[i]``) predicated off as in the kernel."""
    R, mb, max_bpr, bm, bk = panel.shape
    K, N = dense.shape[-2:]
    kb = max(-(-K // bk), 1)
    dense_t = F.pad(dense, (0, 0, 0, kb * bk - K)).view(R, kb, bk, N)
    cols = block_cols.view(mb, max_bpr).long()
    live = (torch.arange(max_bpr, device=panel.device)[None, :]
            < nblocks.long()[:, None])                      # [mb, max_bpr]
    out = panel.new_zeros((R, mb, bm, N))
    for s in range(max_bpr):
        a = torch.where(live[:, s, None, None], panel[:, :, s], 0.0)
        out = out + a @ dense_t[:, cols[:, s]]
    return _epilogue(out.reshape(R, mb * bm, N)[:, :rows], bias, epilogue)


def bsr_spmm_panel(block_cols, nblocks, panel, dense, bias=None, *,
                   rows: int, epilogue: str = "none"):
    """``epilogue(A_panel[r] @ dense[r] (+ bias))`` for every replica ``r``.

    block_cols i32[mb * max_bpr], nblocks i32[mb], panel f32[R, mb, max_bpr,
    bm, bk], dense f32[R, K, N] (rows past ``K`` count as zero), bias
    f32[rows] (for ``bias`` / ``bias_relu``) -> f32[R, rows, N].
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue != "none" and bias is None:
        raise ValueError(f"epilogue {epilogue!r} needs a bias")
    if panel.dim() != 5 or dense.dim() != 3:
        raise ValueError(f"panel must be rank 5 and dense rank 3, got "
                         f"{tuple(panel.shape)} and {tuple(dense.shape)}")
    R, mb, max_bpr, bm, bk = panel.shape
    if dense.shape[0] != R:
        raise ValueError(f"dense has {dense.shape[0]} replicas, panel {R}")
    if not 0 <= rows <= mb * bm:
        raise ValueError(f"rows {rows} outside [0, {mb * bm}]")
    if not panel.is_cuda:
        return bsr_spmm_panel_plain(block_cols, nblocks, panel, dense, bias,
                                    rows=rows, epilogue=epilogue)

    guard_no_grad("bsr_spmm_panel", "B3 (bsr_spmm_t_panel) and B4",
                  panel, dense, bias)
    dev = panel.device
    if bias is None:
        bias = torch.zeros(rows, device=dev, dtype=torch.float32)
    check_operands("bsr_spmm_panel", dev,
                   block_cols=(block_cols, torch.int32),
                   nblocks=(nblocks, torch.int32),
                   panel=(panel, torch.float32), dense=(dense, torch.float32),
                   bias=(bias, torch.float32))
    if block_cols.numel() != mb * max_bpr or nblocks.numel() != mb:
        raise ValueError("block metadata does not match the panel shape")
    if bias.shape != (rows,):
        raise ValueError(f"bias {tuple(bias.shape)} != ({rows},)")
    K, N = dense.shape[1:]
    if R > 65535 or mb * -(-bm // 64) > 65535:
        raise ValueError("grid too large for one launch")
    out = torch.empty((R, rows, N), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    err = library().spmm_panel_f32(
        block_cols.data_ptr(), nblocks.data_ptr(), panel.data_ptr(),
        dense.data_ptr(), bias.data_ptr(), out.data_ptr(), R, mb, max_bpr,
        bm, bk, K, N, rows, EPILOGUES[epilogue],
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bsr_spmm_panel")
    bsr_spmm_panel.launches += 1
    return out


bsr_spmm_panel.launches = 0
