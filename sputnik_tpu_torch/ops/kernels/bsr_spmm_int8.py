"""Int8 (W8A8) panel SpMM, transposed SpMM and SDDMM: the CUDA kernels'
wrappers and their plain PyTorch versions.

Replaces three kernels of ``sputnik_tpu/ops/pallas/bsr_spmm_int8.py``:
``bsr_spmm_panel_int8`` (B16a), ``bsr_spmm_t_panel_int8`` (B16b) and
``bsr_sddmm_panel_int8`` (B17); the kernels are ``csrc/bsr_spmm_int8.cu``.

The quantisation grid is part of the result, so every function here
quantises on the JAX kernels' grid (``quant_tile``):

  * the weight: an int8 panel ``[mb, max_bpr, bm, bk]`` with one symmetric
    absmax scale per tile (``quantize_panel_np``; a zero tile divides by 1);
  * B16a: the dense operand per ``[bk, bn]`` tile (block column, column
    tile); B16b: ``g`` per ``[bm, bq]`` tile (row block, column tile);
  * B17: ``lhs`` per ``[bm, 128]`` and ``rhs`` per ``[bk, 128]`` tile, the
    depth cut into chunks of 128 that are rescaled and summed in f32.

A dynamic tile scale is ``max(absmax / 127, 1e-30)`` and a code
``clip(round(x / scale), -127, 127)`` (round half to even, a true divide).
Each tile product is an exact integer sum (float64 here, int32 in the
kernels) rescaled by the product of its two scales before the f32 sum over
tiles, so a kernel and its plain version differ only in the rounding of
those f32 sums. A bf16 operand is upcast to f32 first, which is exact, as
the JAX kernels' ``astype(f32)``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import check_operands, guard_no_grad
from ._build import check, library

__all__ = ["quantize_panel_np", "quant_tile", "div127",
           "bsr_spmm_panel_int8", "bsr_spmm_panel_int8_plain",
           "bsr_spmm_t_panel_int8", "bsr_spmm_t_panel_int8_plain",
           "bsr_sddmm_panel_int8", "bsr_sddmm_panel_int8_plain"]

SDDMM_DEPTH = 128   # B17's depth chunk (JAX ``sddmm_int8``'s ``bd``)
_QAT = "int8.spmm_qat"


def quantize_panel_np(panel: np.ndarray):
    """f32 panel ``[mb, max_bpr, bm, bk]`` -> (int8 panel, f32 scales
    ``[mb, max_bpr]``), symmetric per-tile absmax (the JAX package's
    ``quantize_panel_np``)."""
    panel = np.asarray(panel, np.float32)
    absmax = np.abs(panel).max(axis=(2, 3))
    scales = (absmax / 127.0).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)
    q = np.clip(np.rint(panel / safe[:, :, None, None]), -127, 127)
    return q.astype(np.int8), scales


def div127(x):
    """``x / 127`` as a true divide on every device, as the kernels' and the
    JAX kernels' (PyTorch turns a Python divisor of a CUDA tensor into a
    multiply by its reciprocal, which can differ in the last place and
    move a rounded code)."""
    return x / torch.full((), 127.0, dtype=x.dtype, device=x.device)


def quant_tile(x, tr: int, tc: int):
    """Dynamic int8 quantisation of a 2-D ``x`` on tiles ``[tr, tc]`` (its
    sides multiples of them): ``(codes int8 [R, C], scales f32
    [R // tr, C // tc])``, each tile at ``max(absmax / 127, 1e-30)``."""
    R, C = x.shape
    t = x.float().reshape(R // tr, tr, C // tc, tc)
    scale = div127(t.abs().amax(dim=(1, 3))).clamp(min=1e-30)
    q = torch.clamp(torch.round(t / scale[:, None, :, None]), -127, 127)
    return q.to(torch.int8).reshape(R, C), scale


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _quant_rows(x, n_tiles, tr, tc):
    """``x [rows, cols]`` zero-padded to ``n_tiles * tr`` rows and whole
    column tiles, quantised: codes as float64 ``[n_tiles, tr, cols_pad]``
    and per-column scales ``[n_tiles, cols_pad]``."""
    rows, cols = x.shape
    nct = max(_cdiv(cols, tc), 1)
    xp = F.pad(x.float(), (0, nct * tc - cols, 0, n_tiles * tr - rows))
    q, s = quant_tile(xp, tr, tc)
    return (q.double().view(n_tiles, tr, nct * tc),
            s.repeat_interleave(tc, dim=1))


# -- B16a ---------------------------------------------------------------------


def bsr_spmm_panel_int8_plain(block_cols, nblocks, values_q, scales, dense,
                              *, rows: int, bn: int):
    """Plain version: the dense operand quantised per ``[bk, bn]`` tile,
    then one batched exact integer product per block slot, rescaled by
    ``w_scale * d_scale`` and summed in f32; padded slots are skipped."""
    mb, max_bpr, bm, bk = values_q.shape
    K, N = dense.shape
    kb = max(_cdiv(K, bk), 1)
    dq, ds = _quant_rows(dense, kb, bk, bn)       # [kb, bk, n_pad], [kb, n_pad]
    cols = block_cols.view(mb, max_bpr).long()
    live = ((torch.arange(max_bpr, device=dense.device)[None, :]
             < nblocks.long()[:, None]) & (cols < kb))  # past K: zero tiles
    cols = cols.clamp(max=kb - 1)
    vq = values_q.double()
    out = torch.zeros((mb, bm, dq.shape[-1]), device=dense.device)
    for s in range(max_bpr):
        c = cols[:, s]
        acc = (vq[:, s] @ dq[c]).float()          # exact integers
        sc = scales[:, s, None] * ds[c]            # [mb, n_pad]
        out = torch.where(live[:, s, None, None], out + acc * sc[:, None],
                          out)
    return out.reshape(mb * bm, -1)[:rows, :N]


def bsr_spmm_panel_int8(block_cols, nblocks, values_q, scales, dense, *,
                        rows: int, bn: int):
    """W8A8 ``A_q @ dense``: block_cols i32[mb * max_bpr], nblocks i32[mb],
    values_q i8[mb, max_bpr, bm, bk], scales f32[mb, max_bpr], dense f32 or
    bf16 ``[K, N]`` (rows past ``K`` count as zero), quantised per
    ``[bk, bn]`` tile -> f32 ``[rows, N]``."""
    if values_q.dim() != 4 or dense.dim() != 2:
        raise ValueError(f"values_q must be rank 4 and dense rank 2, got "
                         f"{tuple(values_q.shape)} and {tuple(dense.shape)}")
    mb, max_bpr, bm, bk = values_q.shape
    if scales.shape != (mb, max_bpr):
        raise ValueError(f"scales {tuple(scales.shape)} != {(mb, max_bpr)}")
    if not 0 <= rows <= mb * bm:
        raise ValueError(f"rows {rows} outside [0, {mb * bm}]")
    if bn < 1:
        raise ValueError(f"bn must be positive, got {bn}")
    if not values_q.is_cuda:
        return bsr_spmm_panel_int8_plain(block_cols, nblocks, values_q,
                                         scales, dense, rows=rows, bn=bn)

    guard_no_grad("bsr_spmm_panel_int8", _QAT, scales, dense)
    dev = values_q.device
    dense = dense.float().contiguous()
    check_operands("bsr_spmm_panel_int8", dev,
                   block_cols=(block_cols, torch.int32),
                   nblocks=(nblocks, torch.int32),
                   values_q=(values_q, torch.int8),
                   scales=(scales, torch.float32),
                   dense=(dense, torch.float32))
    if block_cols.numel() != mb * max_bpr or nblocks.numel() != mb:
        raise ValueError("block metadata does not match the panel shape")
    K, N = dense.shape
    kb, nct = _cdiv(K, bk), _cdiv(N, bn)
    out = torch.empty((rows, N), device=dev, dtype=torch.float32)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    if mb * _cdiv(bm, 64) > 65535 or kb > 65535:
        raise ValueError("grid too large for one launch")
    dq = torch.empty((kb, _cdiv(bk, 4), nct * bn), device=dev,
                     dtype=torch.int32)
    ds = torch.empty((kb, nct), device=dev, dtype=torch.float32)
    err = library().spmm_panel_int8(
        block_cols.data_ptr(), nblocks.data_ptr(), values_q.data_ptr(),
        scales.data_ptr(), dense.data_ptr(), dq.data_ptr(), ds.data_ptr(),
        out.data_ptr(), mb, max_bpr, bm, bk, K, N, bn, rows,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bsr_spmm_panel_int8")
    bsr_spmm_panel_int8.launches += 1
    return out


bsr_spmm_panel_int8.launches = 0


# -- B16b ---------------------------------------------------------------------


def bsr_spmm_t_panel_int8_plain(t_src_i, t_src_s, t_nblocks, values_q,
                                scales, g, *, rows: int, bq: int):
    """Plain version: ``g`` quantised per ``[bm, bq]`` tile, then one
    batched exact integer product per slot of the transposed walk,
    rescaled and summed in f32; padded slots are skipped."""
    mb, max_bpr, bm, bk = values_q.shape
    kb = t_nblocks.numel()
    max_bpc = t_src_i.numel() // max(kb, 1)
    gq, gs = _quant_rows(g, mb, bm, bq)           # [mb, bm, q_pad], [mb, q_pad]
    ti = t_src_i.view(kb, max_bpc).long()
    ts = t_src_s.view(kb, max_bpc).long()
    live = (torch.arange(max_bpc, device=g.device)[None, :]
            < t_nblocks.long()[:, None])
    vq = values_q.double()
    out = torch.zeros((kb, bk, gq.shape[-1]), device=g.device)
    for u in range(max_bpc):
        i, s = ti[:, u], ts[:, u]
        acc = (vq[i, s].transpose(-1, -2) @ gq[i]).float()
        sc = scales[i, s][:, None] * gs[i]         # [kb, q_pad]
        out = torch.where(live[:, u, None, None], out + acc * sc[:, None],
                          out)
    return out.reshape(kb * bk, -1)[:rows, :g.shape[1]]


def bsr_spmm_t_panel_int8(t_src_i, t_src_s, t_nblocks, values_q, scales, g,
                          *, rows: int, bq: int):
    """W8A8 ``A_q^T @ g`` off the int8 panel through the transposed walk
    (``t_src_i`` / ``t_src_s`` i32[kb * max_bpc], ``t_nblocks`` i32[kb]):
    g f32 or bf16 ``[M, Q]`` (M <= mb * bm), quantised per ``[bm, bq]``
    tile -> f32 ``[rows, Q]`` with ``rows <= kb * bk``."""
    if values_q.dim() != 4 or g.dim() != 2:
        raise ValueError(f"values_q must be rank 4 and g rank 2, got "
                         f"{tuple(values_q.shape)} and {tuple(g.shape)}")
    mb, max_bpr, bm, bk = values_q.shape
    kb = t_nblocks.numel()
    M, Q = g.shape
    if scales.shape != (mb, max_bpr):
        raise ValueError(f"scales {tuple(scales.shape)} != {(mb, max_bpr)}")
    if M > mb * bm:
        raise ValueError(f"g has {M} rows, the panel {mb * bm}")
    if not 0 <= rows <= kb * bk:
        raise ValueError(f"rows {rows} outside [0, {kb * bk}]")
    if kb == 0 or t_src_i.numel() % kb or t_src_s.shape != t_src_i.shape:
        raise ValueError("transposed metadata shapes disagree")
    if bq < 1:
        raise ValueError(f"bq must be positive, got {bq}")
    if not values_q.is_cuda:
        return bsr_spmm_t_panel_int8_plain(t_src_i, t_src_s, t_nblocks,
                                           values_q, scales, g, rows=rows,
                                           bq=bq)

    guard_no_grad("bsr_spmm_t_panel_int8", _QAT, scales, g)
    dev = values_q.device
    g = g.float().contiguous()
    check_operands("bsr_spmm_t_panel_int8", dev,
                   t_src_i=(t_src_i, torch.int32),
                   t_src_s=(t_src_s, torch.int32),
                   t_nblocks=(t_nblocks, torch.int32),
                   values_q=(values_q, torch.int8),
                   scales=(scales, torch.float32), g=(g, torch.float32))
    nqt = _cdiv(Q, bq)
    out = torch.empty((rows, Q), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    if kb * _cdiv(bk, 64) > 65535 or mb > 65535:
        raise ValueError("grid too large for one launch")
    gq = torch.empty((mb, _cdiv(bm, 4), nqt * bq), device=dev,
                     dtype=torch.int32)
    gs = torch.empty((mb, nqt), device=dev, dtype=torch.float32)
    err = library().spmm_t_panel_int8(
        t_src_i.data_ptr(), t_src_s.data_ptr(), t_nblocks.data_ptr(),
        values_q.data_ptr(), scales.data_ptr(), g.data_ptr(), gq.data_ptr(),
        gs.data_ptr(), out.data_ptr(), mb, max_bpr, kb,
        t_src_i.numel() // kb, bm, bk, M, Q, bq, rows,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bsr_spmm_t_panel_int8")
    bsr_spmm_t_panel_int8.launches += 1
    return out


bsr_spmm_t_panel_int8.launches = 0


# -- B17 ----------------------------------------------------------------------


def bsr_sddmm_panel_int8_plain(block_cols, nblocks, lhs, rhs, mask):
    """Plain version: ``lhs`` / ``rhs`` quantised per ``[bm, 128]`` /
    ``[bk, 128]`` tile, one exact integer product per 128-deep chunk,
    rescaled and summed in f32; masked and padded slots are exact 0."""
    mb, max_bpr, bm, bk = mask.shape
    M, D = lhs.shape
    kb = max(_cdiv(rhs.shape[0], bk), 1)
    dt = max(_cdiv(D, SDDMM_DEPTH), 1)
    lq, ls = _quant_rows(lhs, mb, bm, SDDMM_DEPTH)  # [mb, bm, dt*128]
    rq, rs = _quant_rows(rhs, kb, bk, SDDMM_DEPTH)  # [kb, bk, dt*128]
    ls, rs = ls[:, ::SDDMM_DEPTH], rs[:, ::SDDMM_DEPTH]   # [mb | kb, dt]
    cols = block_cols.view(mb, max_bpr).long()
    live = ((torch.arange(max_bpr, device=lhs.device)[None, :]
             < nblocks.long()[:, None]) & (cols < kb))
    cols = cols.clamp(max=kb - 1)
    acc = torch.zeros(mask.shape, device=lhs.device)
    for t in range(dt):
        d = slice(t * SDDMM_DEPTH, (t + 1) * SDDMM_DEPTH)
        prod = torch.einsum("imd,iskd->ismk", lq[:, :, d],
                            rq[:, :, d][cols]).float()
        acc = acc + prod * (ls[:, t, None] * rs[cols, t])[..., None, None]
    keep = (mask != 0) & live[:, :, None, None]
    return torch.where(keep, acc * mask, 0.0)


def bsr_sddmm_panel_int8(block_cols, nblocks, lhs, rhs, mask):
    """Int8 sampled ``lhs @ rhs^T``: lhs f32 or bf16 ``[M, D]`` (M <= mb *
    bm), rhs ``[Nr, D]``, mask f32[mb, max_bpr, bm, bk] -> f32 panel
    ``[mb, max_bpr, bm, bk]``, exact 0 at masked and padded slots."""
    if lhs.dim() != 2 or rhs.dim() != 2 or mask.dim() != 4:
        raise ValueError("lhs and rhs must be rank 2 and mask rank 4")
    mb, max_bpr, bm, bk = mask.shape
    M, D = lhs.shape
    if rhs.shape[1] != D:
        raise ValueError(f"rhs {tuple(rhs.shape)} does not match lhs "
                         f"{tuple(lhs.shape)}")
    if M > mb * bm:
        raise ValueError(f"lhs has {M} rows, the panel {mb * bm}")
    if D == 0:
        raise ValueError("sddmm needs a positive depth")
    if not lhs.is_cuda:
        return bsr_sddmm_panel_int8_plain(block_cols, nblocks, lhs, rhs,
                                          mask)

    guard_no_grad("bsr_sddmm_panel_int8", _QAT, lhs, rhs)
    dev = lhs.device
    lhs, rhs = lhs.float().contiguous(), rhs.float().contiguous()
    check_operands("bsr_sddmm_panel_int8", dev,
                   block_cols=(block_cols, torch.int32),
                   nblocks=(nblocks, torch.int32),
                   lhs=(lhs, torch.float32), rhs=(rhs, torch.float32),
                   mask=(mask, torch.float32))
    if block_cols.numel() != mb * max_bpr or nblocks.numel() != mb:
        raise ValueError("block metadata does not match the mask shape")
    Nr = rhs.shape[0]
    out = torch.empty(mask.shape, device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    if Nr == 0:
        return out.zero_()
    kb, dt = _cdiv(Nr, bk), _cdiv(D, SDDMM_DEPTH)
    if mb * max_bpr > 65535 or max(mb, kb) > 65535:
        raise ValueError("grid too large for one launch")
    lq = torch.empty((mb * bm, dt * SDDMM_DEPTH), device=dev, dtype=torch.int8)
    rq = torch.empty((kb * bk, dt * SDDMM_DEPTH), device=dev, dtype=torch.int8)
    ls = torch.empty((mb, dt), device=dev, dtype=torch.float32)
    rs = torch.empty((kb, dt), device=dev, dtype=torch.float32)
    err = library().sddmm_panel_int8(
        block_cols.data_ptr(), nblocks.data_ptr(), lhs.data_ptr(),
        rhs.data_ptr(), mask.data_ptr(), lq.data_ptr(), rq.data_ptr(),
        ls.data_ptr(), rs.data_ptr(), out.data_ptr(), mb, max_bpr, bm, bk, M,
        Nr, D, torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bsr_sddmm_panel_int8")
    bsr_sddmm_panel_int8.launches += 1
    return out


bsr_sddmm_panel_int8.launches = 0
