"""Transposed panel SpMM ``A^T @ G``: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``sputnik_tpu/ops/pallas/bsr_spmm_t.py:bsr_spmm_t_panel``; the
kernel is ``csrc/bsr_spmm_t.cu``. It reads the ORIGINAL panel
``[R, mb, max_bpr, bm, bk]`` through the transposed block metadata of
``BlockView.transpose_meta`` (``t_src_i``, ``t_src_s`` ``[kb * max_bpc]``,
``t_nblocks`` ``[kb]``): no transposed panel is built.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import check_operands, guard_no_grad
from ._build import check, library

__all__ = ["bsr_spmm_t_panel", "bsr_spmm_t_panel_plain"]


def bsr_spmm_t_panel_plain(t_src_i, t_src_s, t_nblocks, panel, g, *,
                           rows: int):
    """Plain version: a gather of each block column's source tiles over the
    transposed metadata, one batched product per slot; padded slots
    (``u >= t_nblocks[j]``) are predicated off as in the kernel."""
    R, mb, max_bpr, bm, bk = panel.shape
    kb = t_nblocks.numel()
    max_bpc = t_src_i.numel() // max(kb, 1)
    M, Q = g.shape[-2:]
    g_t = F.pad(g, (0, 0, 0, mb * bm - M)).view(R, mb, bm, Q)
    ti = t_src_i.view(kb, max_bpc).long()
    ts = t_src_s.view(kb, max_bpc).long()
    live = (torch.arange(max_bpc, device=panel.device)[None, :]
            < t_nblocks.long()[:, None])                    # [kb, max_bpc]
    out = panel.new_zeros((R, kb, bk, Q))
    for u in range(max_bpc):
        tiles = torch.where(live[:, u, None, None],
                            panel[:, ti[:, u], ts[:, u]], 0.0)  # [R,kb,bm,bk]
        out = out + tiles.transpose(-1, -2) @ g_t[:, ti[:, u]]
    return out.reshape(R, kb * bk, Q)[:, :rows]


def bsr_spmm_t_panel(t_src_i, t_src_s, t_nblocks, panel, g, *, rows: int):
    """``A_panel[r]^T @ g[r]`` for every replica ``r``.

    t_src_i / t_src_s i32[kb * max_bpc], t_nblocks i32[kb], panel
    f32[R, mb, max_bpr, bm, bk], g f32[R, M, Q] (M <= mb * bm; rows past
    ``M`` count as zero) -> f32[R, rows, Q] with ``rows <= kb * bk``.
    """
    if panel.dim() != 5 or g.dim() != 3:
        raise ValueError(f"panel must be rank 5 and g rank 3, got "
                         f"{tuple(panel.shape)} and {tuple(g.shape)}")
    R, mb, max_bpr, bm, bk = panel.shape
    kb = t_nblocks.numel()
    if g.shape[0] != R:
        raise ValueError(f"g has {g.shape[0]} replicas, panel {R}")
    M, Q = g.shape[1:]
    if M > mb * bm:
        raise ValueError(f"g has {M} rows, the panel {mb * bm}")
    if not 0 <= rows <= kb * bk:
        raise ValueError(f"rows {rows} outside [0, {kb * bk}]")
    if kb == 0 or t_src_i.numel() % kb or t_src_s.shape != t_src_i.shape:
        raise ValueError("transposed metadata shapes disagree")
    if not panel.is_cuda:
        return bsr_spmm_t_panel_plain(t_src_i, t_src_s, t_nblocks, panel, g,
                                      rows=rows)

    guard_no_grad("bsr_spmm_t_panel", "panel_api.spmm_t", panel, g)
    dev = panel.device
    check_operands("bsr_spmm_t_panel", dev,
                   t_src_i=(t_src_i, torch.int32),
                   t_src_s=(t_src_s, torch.int32),
                   t_nblocks=(t_nblocks, torch.int32),
                   panel=(panel, torch.float32), g=(g, torch.float32))
    if R > 65535 or kb * -(-bk // 64) > 65535:
        raise ValueError("grid too large for one launch")
    out = torch.empty((R, rows, Q), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    err = library().spmm_t_panel_f32(
        t_src_i.data_ptr(), t_src_s.data_ptr(), t_nblocks.data_ptr(),
        panel.data_ptr(), g.data_ptr(), out.data_ptr(), R, mb, max_bpr, kb,
        t_src_i.numel() // kb, bm, bk, M, Q, rows,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bsr_spmm_t_panel")
    bsr_spmm_t_panel.launches += 1
    return out


bsr_spmm_t_panel.launches = 0
