"""The many-mask batch of panel kernels: the CUDA wrappers and their plain
PyTorch versions.

Replaces the TPU kernels of ``sputnik_tpu/ops/batched_panel.py``:
``_k_spmm_bh`` (B6, ``spmm_bh_kernel``), ``_k_sddmm_bh`` (B7,
``sddmm_bh_kernel``) and ``_k_spmm_t_bh`` (B8, ``spmm_t_bh_kernel``). The
kernels are the panel kernels' bodies (``csrc/bsr_spmm.cu``,
``csrc/bsr_sddmm.cu``, ``csrc/bsr_spmm_t.cu``) with the block metadata
stacked per mask, as ``blocking.stack_block_meta`` gives it:
``block_cols [B, mb*max_bpr]``, ``nblocks [B, mb]``,
``mask [B, mb, max_bpr, bm, bk]``, ``t_src_i / t_src_s [B, kb*max_bpc]``,
``t_nblocks [B, kb]``. There are ``R = B * heads`` replicas and replica
``r`` reads the metadata of mask ``r // heads``; masks differ in their
occupied tiles, so one replica's padded slots may be its neighbour's live
ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import check_operands, guard_no_grad
from ._build import check, library

__all__ = ["spmm_bh_kernel", "spmm_bh_kernel_plain", "sddmm_bh_kernel",
           "sddmm_bh_kernel_plain", "spmm_t_bh_kernel",
           "spmm_t_bh_kernel_plain"]

_GRID_MAX = 65535


def _per_replica(meta, heads: int, *shape):
    """Per-mask metadata ``[B, ...]`` as ``[R, *shape]`` int64 indices."""
    return meta.reshape(meta.shape[0], *shape).long().repeat_interleave(
        heads, dim=0)


def _replicas(name, R, B, heads):
    if heads < 1 or R != B * heads:
        raise ValueError(f"{name}: {R} replicas is not {B} masks x {heads} "
                         f"heads")


def spmm_bh_kernel_plain(block_cols, nblocks, panels, dense, *, heads: int,
                         rows: int):
    """Plain version: for every slot, one batched product of each replica's
    tile with the dense rows its own mask's block column names; padded
    slots (``s >= nblocks[r // heads, i]``) are predicated off."""
    R, mb, max_bpr, bm, bk = panels.shape
    K, N = dense.shape[-2:]
    kb = max(-(-K // bk), 1)
    dense_t = F.pad(dense, (0, 0, 0, kb * bk - K)).view(R, kb, bk, N)
    cols = _per_replica(block_cols, heads, mb, max_bpr)      # [R, mb, max_bpr]
    nblk = _per_replica(nblocks, heads, mb)                  # [R, mb]
    ridx = torch.arange(R, device=panels.device)[:, None]
    out = panels.new_zeros((R, mb, bm, N))
    for s in range(max_bpr):
        a = torch.where((s < nblk)[:, :, None, None], panels[:, :, s], 0.0)
        out = out + a @ dense_t[ridx, cols[:, :, s]]
    return out.reshape(R, mb * bm, N)[:, :rows]


def spmm_bh_kernel(block_cols, nblocks, panels, dense, *, heads: int,
                   rows: int):
    """``out[r] = A_panels[r] @ dense[r]`` with replica ``r`` on mask
    ``r // heads``.

    block_cols i32[B, mb * max_bpr], nblocks i32[B, mb], panels
    f32[R, mb, max_bpr, bm, bk], dense f32[R, K, N] (rows past ``K`` count
    as zero) -> f32[R, rows, N], ``R = B * heads``.
    """
    if panels.dim() != 5 or dense.dim() != 3:
        raise ValueError(f"panels must be rank 5 and dense rank 3, got "
                         f"{tuple(panels.shape)} and {tuple(dense.shape)}")
    R, mb, max_bpr, bm, bk = panels.shape
    B = nblocks.shape[0]
    _replicas("spmm_bh_kernel", R, B, heads)
    if dense.shape[0] != R:
        raise ValueError(f"dense has {dense.shape[0]} replicas, panels {R}")
    if block_cols.shape != (B, mb * max_bpr) or nblocks.shape != (B, mb):
        raise ValueError("block metadata does not match the panel shape")
    if not 0 <= rows <= mb * bm:
        raise ValueError(f"rows {rows} outside [0, {mb * bm}]")
    if not panels.is_cuda:
        return spmm_bh_kernel_plain(block_cols, nblocks, panels, dense,
                                    heads=heads, rows=rows)

    guard_no_grad("spmm_bh_kernel", "batched_panel.spmm_bh", panels, dense)
    dev = panels.device
    check_operands("spmm_bh_kernel", dev,
                   block_cols=(block_cols, torch.int32),
                   nblocks=(nblocks, torch.int32),
                   panels=(panels, torch.float32),
                   dense=(dense, torch.float32))
    K, N = dense.shape[1:]
    if R > _GRID_MAX or mb * -(-bm // 64) > _GRID_MAX:
        raise ValueError("grid too large for one launch")
    out = torch.empty((R, rows, N), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    err = library().spmm_bh_f32(
        block_cols.data_ptr(), nblocks.data_ptr(), panels.data_ptr(),
        dense.data_ptr(), out.data_ptr(), R, heads, mb, max_bpr, bm, bk, K, N,
        rows, torch.cuda.current_stream(dev).cuda_stream)
    check(err, "spmm_bh_kernel")
    spmm_bh_kernel.launches += 1
    return out


spmm_bh_kernel.launches = 0


def sddmm_bh_kernel_plain(block_cols, nblocks, lhs, rhs, mask, *,
                          heads: int):
    """Plain version: for every slot, each replica's lhs rows against the
    rhs tile of its own mask's block column; masked elements and padded
    slots are exactly 0."""
    B, mb, max_bpr, bm, bk = mask.shape
    R, M, D = lhs.shape
    Nr = rhs.shape[1]
    kb = max(-(-Nr // bk), 1)
    lhs_t = F.pad(lhs, (0, 0, 0, mb * bm - M)).view(R, mb, bm, D)
    rhs_t = F.pad(rhs, (0, 0, 0, kb * bk - Nr)).view(R, kb, bk, D)
    cols = _per_replica(block_cols, heads, mb, max_bpr)
    ridx = torch.arange(R, device=lhs.device)[:, None]
    prod = torch.stack([lhs_t @ rhs_t[ridx, cols[:, :, s]].transpose(-1, -2)
                        for s in range(max_bpr)], dim=2)  # [R,mb,max_bpr,..]
    live = (torch.arange(max_bpr, device=lhs.device)[None, None, :]
            < nblocks.long()[:, :, None])                 # [B, mb, max_bpr]
    keep = (mask != 0) & live[..., None, None]
    out = prod.view(B, heads, mb, max_bpr, bm, bk)
    out = torch.where(keep[:, None], out * mask[:, None], 0.0)
    return out.reshape(R, mb, max_bpr, bm, bk)


def sddmm_bh_kernel(block_cols, nblocks, lhs, rhs, mask, *, heads: int):
    """block_cols i32[B, mb * max_bpr], nblocks i32[B, mb], lhs f32[R, M, D]
    (M <= mb * bm), rhs f32[R, Nr, D], mask f32[B, mb, max_bpr, bm, bk]
    -> f32[R, mb, max_bpr, bm, bk], replica ``r`` on mask ``r // heads``."""
    if lhs.dim() != 3 or rhs.dim() != 3 or mask.dim() != 5:
        raise ValueError("lhs and rhs must be rank 3 and mask rank 5")
    B, mb, max_bpr, bm, bk = mask.shape
    R, M, D = lhs.shape
    _replicas("sddmm_bh_kernel", R, B, heads)
    if rhs.shape[0] != R or rhs.shape[2] != D:
        raise ValueError(f"rhs {tuple(rhs.shape)} does not match lhs "
                         f"{tuple(lhs.shape)}")
    if M > mb * bm:
        raise ValueError(f"lhs has {M} rows, the panel {mb * bm}")
    if block_cols.shape != (B, mb * max_bpr) or nblocks.shape != (B, mb):
        raise ValueError("block metadata does not match the mask shape")
    if not lhs.is_cuda:
        return sddmm_bh_kernel_plain(block_cols, nblocks, lhs, rhs, mask,
                                     heads=heads)

    guard_no_grad("sddmm_bh_kernel", "batched_panel.sddmm_bh", lhs, rhs)
    dev = lhs.device
    check_operands("sddmm_bh_kernel", dev,
                   block_cols=(block_cols, torch.int32),
                   nblocks=(nblocks, torch.int32),
                   lhs=(lhs, torch.float32), rhs=(rhs, torch.float32),
                   mask=(mask, torch.float32))
    if R > _GRID_MAX or mb * max_bpr > _GRID_MAX:
        raise ValueError("grid too large for one launch")
    out = torch.empty((R, mb, max_bpr, bm, bk), device=dev,
                      dtype=torch.float32)
    if out.numel() == 0:
        return out
    err = library().sddmm_bh_f32(
        block_cols.data_ptr(), nblocks.data_ptr(), lhs.data_ptr(),
        rhs.data_ptr(), mask.data_ptr(), out.data_ptr(), R, heads, mb,
        max_bpr, bm, bk, M, rhs.shape[1], D,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "sddmm_bh_kernel")
    sddmm_bh_kernel.launches += 1
    return out


sddmm_bh_kernel.launches = 0


def spmm_t_bh_kernel_plain(t_src_i, t_src_s, t_nblocks, panels, g, *,
                           heads: int, rows: int):
    """Plain version: for every transposed slot, each replica's source tile
    (over its own mask's transposed walk), transposed, times the G rows of
    its row block; padded slots (``u >= t_nblocks[r // heads, j]``) are
    predicated off."""
    R, mb, max_bpr, bm, bk = panels.shape
    B, kb = t_nblocks.shape
    max_bpc = t_src_i.shape[1] // max(kb, 1)
    M, Q = g.shape[-2:]
    g_t = F.pad(g, (0, 0, 0, mb * bm - M)).view(R, mb, bm, Q)
    ti = _per_replica(t_src_i, heads, kb, max_bpc)           # [R, kb, max_bpc]
    ts = _per_replica(t_src_s, heads, kb, max_bpc)
    tn = _per_replica(t_nblocks, heads, kb)                  # [R, kb]
    ridx = torch.arange(R, device=panels.device)[:, None]
    out = panels.new_zeros((R, kb, bk, Q))
    for u in range(max_bpc):
        tiles = torch.where((u < tn)[:, :, None, None],
                            panels[ridx, ti[:, :, u], ts[:, :, u]], 0.0)
        out = out + tiles.transpose(-1, -2) @ g_t[ridx, ti[:, :, u]]
    return out.reshape(R, kb * bk, Q)[:, :rows]


def spmm_t_bh_kernel(t_src_i, t_src_s, t_nblocks, panels, g, *, heads: int,
                     rows: int):
    """``out[r] = A_panels[r]^T @ g[r]`` off the original panels, replica
    ``r`` walking the transposed metadata of mask ``r // heads``.

    t_src_i / t_src_s i32[B, kb * max_bpc], t_nblocks i32[B, kb], panels
    f32[R, mb, max_bpr, bm, bk], g f32[R, M, Q] (M <= mb * bm) ->
    f32[R, rows, Q] with ``rows <= kb * bk``.
    """
    if panels.dim() != 5 or g.dim() != 3 or t_nblocks.dim() != 2:
        raise ValueError(f"panels must be rank 5, g rank 3 and t_nblocks "
                         f"rank 2, got {tuple(panels.shape)}, "
                         f"{tuple(g.shape)}, {tuple(t_nblocks.shape)}")
    R, mb, max_bpr, bm, bk = panels.shape
    B, kb = t_nblocks.shape
    _replicas("spmm_t_bh_kernel", R, B, heads)
    if g.shape[0] != R:
        raise ValueError(f"g has {g.shape[0]} replicas, panels {R}")
    M, Q = g.shape[1:]
    if M > mb * bm:
        raise ValueError(f"g has {M} rows, the panel {mb * bm}")
    if not 0 <= rows <= kb * bk:
        raise ValueError(f"rows {rows} outside [0, {kb * bk}]")
    if (kb == 0 or t_src_i.dim() != 2 or t_src_i.shape[0] != B
            or t_src_i.shape[1] % kb or t_src_s.shape != t_src_i.shape):
        raise ValueError("transposed metadata shapes disagree")
    if not panels.is_cuda:
        return spmm_t_bh_kernel_plain(t_src_i, t_src_s, t_nblocks, panels, g,
                                      heads=heads, rows=rows)

    guard_no_grad("spmm_t_bh_kernel", "batched_panel.spmm_bh / sddmm_bh",
                  panels, g)
    dev = panels.device
    check_operands("spmm_t_bh_kernel", dev,
                   t_src_i=(t_src_i, torch.int32),
                   t_src_s=(t_src_s, torch.int32),
                   t_nblocks=(t_nblocks, torch.int32),
                   panels=(panels, torch.float32), g=(g, torch.float32))
    if R > _GRID_MAX or kb * -(-bk // 64) > _GRID_MAX:
        raise ValueError("grid too large for one launch")
    out = torch.empty((R, rows, Q), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    err = library().spmm_t_bh_f32(
        t_src_i.data_ptr(), t_src_s.data_ptr(), t_nblocks.data_ptr(),
        panels.data_ptr(), g.data_ptr(), out.data_ptr(), R, heads, mb,
        max_bpr, kb, t_src_i.shape[1] // kb, bm, bk, M, Q, rows,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "spmm_t_bh_kernel")
    spmm_t_bh_kernel.launches += 1
    return out


spmm_t_bh_kernel.launches = 0
