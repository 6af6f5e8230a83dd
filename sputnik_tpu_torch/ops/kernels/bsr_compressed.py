"""Compressed (true-BSR) panel kernels: the CUDA kernels' wrappers and their
plain PyTorch versions.

Replaces the five TPU kernels of ``sputnik_tpu/ops/pallas/bsr_compressed.py``:
``bsr_spmm_panel_c`` (B13a), ``bsr_spmm_t_panel_c`` (B13b),
``bsr_sddmm_panel_c`` (B14), ``c_softmax_stats`` (B15a) and
``c_softmax_apply`` (B15b). The sparse operand is the compressed panel
``[R, num_blocks + 1, bm, bk]`` (``blocking.CompressedView``): the occupied
tiles back to back, row-block ``i`` owning tiles ``block_offsets[i] ..
block_offsets[i + 1]``, the last tile a dump that every output keeps at
exactly 0. B13a, B13b and B14 are the bodies of B1, B3 and B4
(``csrc/bsr_spmm.cu``, ``bsr_spmm_t.cu``, ``bsr_sddmm.cu``) on a second
address policy; B15a and B15b are ``csrc/bsr_compressed.cu``.

The plain versions take the same metadata, are vectorised over row-blocks
(block columns for the transposed product) with one step per tile slot, as
the ELL plain versions are, and run in any float dtype (float64 for
``gradcheck``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import check_operands, guard_no_grad
from ._build import check, library
from .bsr_spmm import EPILOGUES, _epilogue

__all__ = ["bsr_spmm_panel_c", "bsr_spmm_panel_c_plain",
           "bsr_spmm_t_panel_c", "bsr_spmm_t_panel_c_plain",
           "bsr_sddmm_panel_c", "bsr_sddmm_panel_c_plain",
           "c_softmax_stats", "c_softmax_stats_plain",
           "c_softmax_apply", "c_softmax_apply_plain"]

_NEG_LARGE = -1e30     # the TPU kernel's masked score
_MIN_DENOM = 1e-30     # the TPU kernel's floor of a row's denominator


def _walk(block_offsets):
    """(first tile, tile count) of every row-block, and the most tiles any
    row-block holds (the number of slot steps)."""
    offs = block_offsets.long()
    first, count = offs[:-1], offs[1:] - offs[:-1]
    steps = int(count.max().item()) if count.numel() else 0
    return first, count, steps


def bsr_spmm_panel_c_plain(block_offsets, block_cols, panel, dense, bias=None,
                           *, rows: int, epilogue: str = "none"):
    """Plain version of B13a: one batched product per slot ``s``, row-block
    ``i`` taking tile ``block_offsets[i] + s`` while ``s`` is below its tile
    count (later slots read the dump tile and are predicated off)."""
    R, T, bm, bk = panel.shape
    K, N = dense.shape[-2:]
    kb = max(-(-K // bk), 1)
    dense_t = F.pad(dense, (0, 0, 0, kb * bk - K)).view(R, kb, bk, N)
    first, count, steps = _walk(block_offsets)
    cols = block_cols.long()
    out = panel.new_zeros((R, count.numel(), bm, N))
    for s in range(steps):
        live = s < count
        g = torch.where(live, first + s, T - 1)
        a = torch.where(live[:, None, None], panel[:, g], 0.0)
        out = out + a @ dense_t[:, cols[g]]
    return _epilogue(out.reshape(R, -1, N)[:, :rows], bias, epilogue)


def bsr_spmm_panel_c(block_offsets, block_cols, panel, dense, bias=None, *,
                     rows: int, epilogue: str = "none"):
    """``epilogue(A[r] @ dense[r] (+ bias))`` over the compressed panel.

    block_offsets i32[mb + 1], block_cols i32[T] (T = num_blocks + 1),
    panel f32[R, T, bm, bk], dense f32[R, K, N] (rows past ``K`` count as
    zero), bias f32[rows] (for ``bias`` / ``bias_relu``) -> f32[R, rows, N].
    A row-block without tiles gives exactly 0 (+ bias).
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue != "none" and bias is None:
        raise ValueError(f"epilogue {epilogue!r} needs a bias")
    if panel.dim() != 4 or dense.dim() != 3:
        raise ValueError(f"panel must be rank 4 and dense rank 3, got "
                         f"{tuple(panel.shape)} and {tuple(dense.shape)}")
    R, T, bm, bk = panel.shape
    mb = block_offsets.numel() - 1
    if dense.shape[0] != R:
        raise ValueError(f"dense has {dense.shape[0]} replicas, panel {R}")
    if mb < 1 or block_cols.numel() != T:
        raise ValueError("block metadata does not match the panel shape")
    if not 0 <= rows <= mb * bm:
        raise ValueError(f"rows {rows} outside [0, {mb * bm}]")
    if not panel.is_cuda:
        return bsr_spmm_panel_c_plain(block_offsets, block_cols, panel, dense,
                                      bias, rows=rows, epilogue=epilogue)

    guard_no_grad("bsr_spmm_panel_c",
                  "panel_api.spmm / spmm_bias / spmm_bias_relu on a "
                  "compressed PanelSpec", panel, dense, bias)
    dev = panel.device
    if bias is None:
        bias = torch.zeros(rows, device=dev, dtype=torch.float32)
    check_operands("bsr_spmm_panel_c", dev,
                   block_offsets=(block_offsets, torch.int32),
                   block_cols=(block_cols, torch.int32),
                   panel=(panel, torch.float32), dense=(dense, torch.float32),
                   bias=(bias, torch.float32))
    if bias.shape != (rows,):
        raise ValueError(f"bias {tuple(bias.shape)} != ({rows},)")
    K, N = dense.shape[1:]
    if R > 65535 or mb * -(-bm // 64) > 65535:
        raise ValueError("grid too large for one launch")
    out = torch.empty((R, rows, N), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    err = library().spmm_panel_c_f32(
        block_offsets.data_ptr(), block_cols.data_ptr(), panel.data_ptr(),
        dense.data_ptr(), bias.data_ptr(), out.data_ptr(), R, mb, T, bm, bk,
        K, N, rows, EPILOGUES[epilogue],
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bsr_spmm_panel_c")
    bsr_spmm_panel_c.launches += 1
    return out


bsr_spmm_panel_c.launches = 0


def bsr_spmm_t_panel_c_plain(t_gblk, t_rows, t_nblocks, panel, g, *,
                             rows: int):
    """Plain version of B13b: per slot ``u``, block column ``j`` takes tile
    ``t_gblk[j, u]`` against the g rows of row-block ``t_rows[j, u]`` while
    ``u < t_nblocks[j]`` (the padded slots, which repeat the last pair, are
    predicated off)."""
    R, T, bm, bk = panel.shape
    kb = t_nblocks.numel()
    max_bpc = t_gblk.numel() // max(kb, 1)
    M, Q = g.shape[-2:]
    tr = t_rows.view(kb, max_bpc).long()
    mb = max(-(-M // bm), int(tr.max().item()) + 1 if tr.numel() else 1)
    g_t = F.pad(g, (0, 0, 0, mb * bm - M)).view(R, mb, bm, Q)
    gb = t_gblk.view(kb, max_bpc).long()
    live = (torch.arange(max_bpc, device=panel.device)[None, :]
            < t_nblocks.long()[:, None])                    # [kb, max_bpc]
    out = panel.new_zeros((R, kb, bk, Q))
    for u in range(max_bpc):
        tiles = torch.where(live[:, u, None, None], panel[:, gb[:, u]], 0.0)
        out = out + tiles.transpose(-1, -2) @ g_t[:, tr[:, u]]
    return out.reshape(R, kb * bk, Q)[:, :rows]


def bsr_spmm_t_panel_c(t_gblk, t_rows, t_nblocks, panel, g, *, rows: int):
    """``A[r]^T @ g[r]`` off the compressed panel, by global tile ids.

    t_gblk / t_rows i32[kb * max_bpc] (``CompressedView.transpose_meta``),
    t_nblocks i32[kb], panel f32[R, T, bm, bk], g f32[R, M, Q] (rows past
    ``M`` count as zero) -> f32[R, rows, Q] with ``rows <= kb * bk``. A
    block column without tiles gives exactly 0.
    """
    if panel.dim() != 4 or g.dim() != 3:
        raise ValueError(f"panel must be rank 4 and g rank 3, got "
                         f"{tuple(panel.shape)} and {tuple(g.shape)}")
    R, T, bm, bk = panel.shape
    kb = t_nblocks.numel()
    if g.shape[0] != R:
        raise ValueError(f"g has {g.shape[0]} replicas, panel {R}")
    if not 0 <= rows <= kb * bk:
        raise ValueError(f"rows {rows} outside [0, {kb * bk}]")
    if kb == 0 or t_gblk.numel() % kb or t_rows.shape != t_gblk.shape:
        raise ValueError("transposed metadata shapes disagree")
    if not panel.is_cuda:
        return bsr_spmm_t_panel_c_plain(t_gblk, t_rows, t_nblocks, panel, g,
                                        rows=rows)

    guard_no_grad("bsr_spmm_t_panel_c",
                  "panel_api.spmm_t on a compressed PanelSpec", panel, g)
    dev = panel.device
    check_operands("bsr_spmm_t_panel_c", dev,
                   t_gblk=(t_gblk, torch.int32), t_rows=(t_rows, torch.int32),
                   t_nblocks=(t_nblocks, torch.int32),
                   panel=(panel, torch.float32), g=(g, torch.float32))
    M, Q = g.shape[1:]
    if R > 65535 or kb * -(-bk // 64) > 65535:
        raise ValueError("grid too large for one launch")
    out = torch.empty((R, rows, Q), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    err = library().spmm_t_panel_c_f32(
        t_gblk.data_ptr(), t_rows.data_ptr(), t_nblocks.data_ptr(),
        panel.data_ptr(), g.data_ptr(), out.data_ptr(), R, T, kb,
        t_gblk.numel() // kb, bm, bk, M, Q, rows,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bsr_spmm_t_panel_c")
    bsr_spmm_t_panel_c.launches += 1
    return out


bsr_spmm_t_panel_c.launches = 0


def bsr_sddmm_panel_c_plain(block_rows, block_cols, lhs, rhs, mask):
    """Plain version of B14: one batched product over the real tiles, each
    sampling the lhs rows of its row-block and the rhs rows of its block
    column; masked elements and the dump tile exactly 0."""
    T, bm, bk = mask.shape
    R, M, D = lhs.shape
    Nr = rhs.shape[1]
    nblk = T - 1
    rows, cols = block_rows[:nblk].long(), block_cols[:nblk].long()
    mb = max(-(-M // bm), int(rows.max().item()) + 1 if nblk else 1)
    kb = max(-(-Nr // bk), int(cols.max().item()) + 1 if nblk else 1)
    lhs_t = F.pad(lhs, (0, 0, 0, mb * bm - M)).view(R, mb, bm, D)
    rhs_t = F.pad(rhs, (0, 0, 0, kb * bk - Nr)).view(R, kb, bk, D)
    prod = torch.einsum("rgmd,rgkd->rgmk", lhs_t[:, rows], rhs_t[:, cols])
    live = mask[:nblk]
    out = torch.where(live != 0, prod * live, 0.0)
    return torch.cat([out, out.new_zeros((R, 1, bm, bk))], dim=1)


def bsr_sddmm_panel_c(block_rows, block_cols, lhs, rhs, mask):
    """Sampled ``lhs[r] @ rhs[r]^T`` into the compressed panel.

    block_rows / block_cols i32[T] (each tile's row-block and block column,
    T = num_blocks + 1), lhs f32[R, M, D], rhs f32[R, Nr, D] (rows past
    ``M`` / ``Nr`` count as zero), mask f32[T, bm, bk] -> f32[R, T, bm, bk],
    exactly 0 at masked elements and in the dump tile ``T - 1``.
    """
    if lhs.dim() != 3 or rhs.dim() != 3 or mask.dim() != 3:
        raise ValueError("lhs and rhs must be rank 3 and mask rank 3")
    T, bm, bk = mask.shape
    R, M, D = lhs.shape
    if rhs.shape[0] != R or rhs.shape[2] != D:
        raise ValueError(f"rhs {tuple(rhs.shape)} does not match lhs "
                         f"{tuple(lhs.shape)}")
    if T < 1 or block_rows.numel() != T or block_cols.numel() != T:
        raise ValueError("block metadata does not match the mask shape")
    if not lhs.is_cuda:
        return bsr_sddmm_panel_c_plain(block_rows, block_cols, lhs, rhs, mask)

    guard_no_grad("bsr_sddmm_panel_c",
                  "panel_api.sddmm on a compressed PanelSpec", lhs, rhs)
    dev = lhs.device
    check_operands("bsr_sddmm_panel_c", dev,
                   block_rows=(block_rows, torch.int32),
                   block_cols=(block_cols, torch.int32),
                   lhs=(lhs, torch.float32), rhs=(rhs, torch.float32),
                   mask=(mask, torch.float32))
    if R > 65535 or T > 65535:
        raise ValueError("grid too large for one launch")
    out = torch.empty((R, T, bm, bk), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    err = library().sddmm_panel_c_f32(
        block_rows.data_ptr(), block_cols.data_ptr(), lhs.data_ptr(),
        rhs.data_ptr(), mask.data_ptr(), out.data_ptr(), R, T, bm, bk, M,
        rhs.shape[1], D, torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bsr_sddmm_panel_c")
    bsr_sddmm_panel_c.launches += 1
    return out


bsr_sddmm_panel_c.launches = 0


def c_softmax_stats_plain(block_offsets, panel, mask):
    """Plain version of B15a: per slot ``s``, every row of row-block ``i``
    folds tile ``block_offsets[i] + s`` into its running max and
    denominator, online as the TPU kernel does (masked elements score
    -1e30; the denominator is rescaled by ``exp(m_prev - m_new)``)."""
    R, T, bm, bk = panel.shape
    first, count, steps = _walk(block_offsets)
    mb = count.numel()
    row_max = panel.new_full((R, mb, bm, 1), _NEG_LARGE)
    row_denom = panel.new_zeros((R, mb, bm, 1))
    for s in range(steps):
        live = s < count
        g = torch.where(live, first + s, T - 1)
        keep = mask[g] != 0                                 # [mb, bm, bk]
        v = torch.where(keep, panel[:, g], _NEG_LARGE)
        m_new = torch.maximum(row_max, v.amax(dim=-1, keepdim=True))
        p = torch.where(keep, torch.exp(v - m_new), 0.0)
        l_new = (row_denom * torch.exp(row_max - m_new)
                 + p.sum(dim=-1, keepdim=True))
        live = live[:, None, None]
        row_max = torch.where(live, m_new, row_max)
        row_denom = torch.where(live, l_new, row_denom)
    return row_max.reshape(R, mb * bm), row_denom.reshape(R, mb * bm)


def c_softmax_stats(block_offsets, panel, mask):
    """Per-row max and softmax denominator over the ragged tiles of each
    row-block: block_offsets i32[mb + 1], panel f32[R, T, bm, bk], mask
    f32[T, bm, bk] -> (row_max, row_denom) f32[R, mb * bm] each. A row
    without nonzeros gives (-1e30, 0)."""
    if panel.dim() != 4 or mask.dim() != 3:
        raise ValueError(f"panel must be rank 4 and mask rank 3, got "
                         f"{tuple(panel.shape)} and {tuple(mask.shape)}")
    R, T, bm, bk = panel.shape
    mb = block_offsets.numel() - 1
    if mb < 1 or tuple(mask.shape) != (T, bm, bk):
        raise ValueError("block metadata does not match the panel shape")
    if not panel.is_cuda:
        return c_softmax_stats_plain(block_offsets, panel, mask)

    guard_no_grad("c_softmax_stats",
                  "panel_api.sparse_softmax on a compressed PanelSpec", panel)
    dev = panel.device
    check_operands("c_softmax_stats", dev,
                   block_offsets=(block_offsets, torch.int32),
                   panel=(panel, torch.float32), mask=(mask, torch.float32))
    row_max = torch.empty((R, mb * bm), device=dev, dtype=torch.float32)
    row_denom = torch.empty_like(row_max)
    if row_max.numel() == 0:
        return row_max, row_denom
    err = library().c_softmax_stats_f32(
        block_offsets.data_ptr(), panel.data_ptr(), mask.data_ptr(),
        row_max.data_ptr(), row_denom.data_ptr(), R, mb, T, bm, bk,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "c_softmax_stats")
    c_softmax_stats.launches += 1
    return row_max, row_denom


c_softmax_stats.launches = 0


def c_softmax_apply_plain(block_rows, panel, mask, row_max, row_denom):
    """Plain version of B15b: ``exp(v - m[row]) / max(l[row], 1e-30)`` where
    the mask is set, exactly 0 elsewhere and in the dump tile."""
    R, T, bm, bk = panel.shape
    rows = (block_rows.long()[:, None] * bm
            + torch.arange(bm, device=panel.device)[None, :])  # [T, bm]
    m = row_max[:, rows][..., None]
    den = row_denom[:, rows][..., None].clamp(min=_MIN_DENOM)
    keep = (mask != 0) & (torch.arange(T, device=panel.device)
                          < T - 1)[:, None, None]
    return torch.where(keep, torch.exp(panel - m) / den, 0.0)


def c_softmax_apply(block_rows, panel, mask, row_max, row_denom):
    """Normalise each tile against its row-block's statistics: block_rows
    i32[T], panel f32[R, T, bm, bk], mask f32[T, bm, bk], row_max /
    row_denom f32[R, M] (``M >= (max block_rows + 1) * bm``) ->
    f32[R, T, bm, bk], exactly 0 at masked elements and in the dump tile."""
    if panel.dim() != 4 or mask.dim() != 3 or row_max.dim() != 2:
        raise ValueError("panel must be rank 4, mask rank 3 and the row "
                         "statistics rank 2")
    R, T, bm, bk = panel.shape
    if tuple(mask.shape) != (T, bm, bk) or block_rows.numel() != T:
        raise ValueError("block metadata does not match the panel shape")
    if row_max.shape != row_denom.shape or row_max.shape[0] != R:
        raise ValueError(f"row statistics {tuple(row_max.shape)} / "
                         f"{tuple(row_denom.shape)} do not match R = {R}")
    if not panel.is_cuda:
        return c_softmax_apply_plain(block_rows, panel, mask, row_max,
                                     row_denom)

    guard_no_grad("c_softmax_apply",
                  "panel_api.sparse_softmax on a compressed PanelSpec",
                  panel, row_max, row_denom)
    dev = panel.device
    check_operands("c_softmax_apply", dev,
                   block_rows=(block_rows, torch.int32),
                   panel=(panel, torch.float32), mask=(mask, torch.float32),
                   row_max=(row_max, torch.float32),
                   row_denom=(row_denom, torch.float32))
    if R > 65535:
        raise ValueError("grid too large for one launch")
    out = torch.empty_like(panel)
    if out.numel() == 0:
        return out
    err = library().c_softmax_apply_f32(
        block_rows.data_ptr(), panel.data_ptr(), mask.data_ptr(),
        row_max.data_ptr(), row_denom.data_ptr(), out.data_ptr(), R, T, bm,
        bk, row_max.shape[1], torch.cuda.current_stream(dev).cuda_stream)
    check(err, "c_softmax_apply")
    c_softmax_apply.launches += 1
    return out


c_softmax_apply.launches = 0
