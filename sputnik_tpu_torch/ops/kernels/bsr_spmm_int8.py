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

On the card B16a and B16b run the activation's pre-pass (``quant_kmajor``:
the tile scales and the codes K-major, ``[row tile][column][kp]``, stored
in wgmma's core-matrix order, ``to_core_tiles``) and then one tensor-core
product body; ``kmajor_plan`` is their padded layout, and
``quant_kmajor_plain`` the pre-pass's plain twin, which the plain products
read too. B17 runs its own pre-pass (``sddmm_quant_plain`` is its plain
twin: per-``[tile rows, 128]``-chunk scales and codes K-major along the
depth, one ``[64, 128]`` piece per 64-row slice of a tile) and then one
tensor-core product body.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import check_operands, guard_no_grad
from ._build import check, library

__all__ = ["quantize_panel_np", "quant_tile", "div127", "kmajor_plan",
           "to_core_tiles", "quant_kmajor", "quant_kmajor_plain",
           "sddmm_quant_plain",
           "bsr_spmm_panel_int8", "bsr_spmm_panel_int8_plain",
           "bsr_spmm_t_panel_int8", "bsr_spmm_t_panel_int8_plain",
           "bsr_sddmm_panel_int8", "bsr_sddmm_panel_int8_plain"]

SDDMM_DEPTH = 128   # B17's depth chunk (JAX ``sddmm_int8``'s ``bd``)
KSTEP = 64          # code bytes a stage of the B16a / B16b product holds
BLOCK_COLS = 128    # output columns a block of the product owns
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


def kmajor_plan(depth: int, width: int):
    """The B16a / B16b product's layout for slots ``depth`` codes deep (bk,
    resp. bm) and ``width`` output columns: ``(kp, ncols)``, the depth
    padded to whole stages and the width to whole blocks (each row tile of
    codes is ``[ncols, kp]``)."""
    return _cdiv(depth, KSTEP) * KSTEP, _cdiv(width, BLOCK_COLS) * BLOCK_COLS


def to_core_tiles(codes):
    """K-major codes ``[T, R, kp]`` (R a multiple of 8, kp of 16) in
    wgmma's core-matrix order: ``[T, R // 8, kp // 16, 8, 16]``, each core
    matrix 8 rows x 16 bytes of the contraction."""
    T, R, kp = codes.shape
    return (codes.view(T, R // 8, 8, kp // 16, 16).permute(0, 1, 3, 2, 4)
            .contiguous())


def quant_kmajor_plain(x, tr: int, tc: int, n_tiles: int, kp=None,
                       ncols=None):
    """``x [rows, cols]`` (rows past ``rows`` and columns past ``cols``
    zero) quantised per ``[tr, tc]`` tile, the codes K-major: ``(codes int8
    [n_tiles, ncols, kp], scales f32 [n_tiles, nct])``, where ``codes[t, n,
    k]`` is the code of ``x[t * tr + k, n]`` for ``k < tr`` and 0 beyond.
    ``kp`` defaults to ``tr`` and ``ncols`` to the whole column tiles."""
    rows, cols = x.shape
    nct = max(_cdiv(cols, tc), 1)
    kp = tr if kp is None else kp
    ncols = nct * tc if ncols is None else ncols
    xp = F.pad(x.float(), (0, nct * tc - cols, 0, n_tiles * tr - rows))
    q, s = quant_tile(xp, tr, tc)
    q = q.view(n_tiles, tr, nct * tc).transpose(1, 2)[:, :ncols]
    codes = torch.zeros((n_tiles, ncols, kp), dtype=torch.int8,
                        device=x.device)
    codes[:, :q.shape[1], :tr] = q
    return codes, s


def quant_kmajor(x, tr: int, tc: int, n_tiles: int):
    """The B16a / B16b pre-pass: ``to_core_tiles(quant_kmajor_plain(x, tr,
    tc, n_tiles, kp, ncols))`` and the scales, with ``kp, ncols`` from
    ``kmajor_plan(tr, cols)``; on the card two launches (the tile maxima,
    then the codes)."""
    rows, cols = x.shape
    kp, ncols = kmajor_plan(tr, cols)
    if not x.is_cuda:
        codes, scale = quant_kmajor_plain(x, tr, tc, n_tiles, kp, ncols)
        return to_core_tiles(codes), scale
    x = x.float().contiguous()
    nct = _cdiv(cols, tc)
    if n_tiles > 65535 or nct == 0:
        raise ValueError(f"quant_kmajor: {n_tiles} row tiles of "
                         f"{tuple(x.shape)} do not fit one launch")
    tmax = torch.empty((n_tiles, nct), device=x.device, dtype=torch.int32)
    scale = torch.empty((n_tiles, nct), device=x.device, dtype=torch.float32)
    codes = torch.empty((n_tiles, ncols // 8, kp // 16, 8, 16),
                        device=x.device, dtype=torch.int8)
    err = library().quant_kmajor(
        x.data_ptr(), tmax.data_ptr(), scale.data_ptr(), codes.data_ptr(),
        rows, cols, tr, tc, n_tiles, kp, ncols,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "quant_kmajor")
    quant_kmajor.launches += 1
    return codes, scale


quant_kmajor.launches = 0


def _quant_rows(x, n_tiles, tr, tc):
    """``x [rows, cols]`` zero-padded to ``n_tiles * tr`` rows and whole
    column tiles, quantised: codes as float64 ``[n_tiles, tr, cols_pad]``
    and per-column scales ``[n_tiles, cols_pad]``."""
    codes, s = quant_kmajor_plain(x, tr, tc, n_tiles)
    return codes.transpose(1, 2).double(), s.repeat_interleave(tc, dim=1)


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
    kb = _cdiv(K, bk)
    out = torch.empty((rows, N), device=dev, dtype=torch.float32)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    if mb * _cdiv(bm, 64) > 65535:
        raise ValueError("grid too large for one launch")
    dq, ds = quant_kmajor(dense, bk, bn, kb)
    err = library().spmm_panel_int8(
        block_cols.data_ptr(), nblocks.data_ptr(), values_q.data_ptr(),
        scales.data_ptr(), dq.data_ptr(), ds.data_ptr(), out.data_ptr(), mb,
        max_bpr, bm, bk, kb, N, bn, rows,
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
    out = torch.empty((rows, Q), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    if kb * _cdiv(bk, 64) > 65535:
        raise ValueError("grid too large for one launch")
    max_bpc = t_src_i.numel() // kb
    gq, gs = quant_kmajor(g, bm, bq, mb)
    kp = kmajor_plan(bm, Q)[0]
    vqt = torch.empty((kb * max_bpc, _cdiv(bk, 8) * 8, kp), device=dev,
                      dtype=torch.int8)
    err = library().spmm_t_panel_int8(
        t_src_i.data_ptr(), t_src_s.data_ptr(), t_nblocks.data_ptr(),
        values_q.data_ptr(), scales.data_ptr(), gq.data_ptr(), gs.data_ptr(),
        vqt.data_ptr(), out.data_ptr(), max_bpr, kb, max_bpc, bm, bk, Q, bq,
        rows, torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bsr_spmm_t_panel_int8")
    bsr_spmm_t_panel_int8.launches += 1
    return out


bsr_spmm_t_panel_int8.launches = 0


# -- B17 ----------------------------------------------------------------------


def sddmm_quant_plain(x, tr: int, n_tiles: int):
    """Plain twin of B17's pre-pass (``sddmm_quant_kernel``): ``x [rows,
    D]`` (rows past ``rows`` zero) quantised per ``[tr, 128]`` tile, every
    row of a tile on one scale per 128-deep chunk. Returns ``(codes int8
    [n_tiles, dt, nsl * 64, 128], scales f32 [n_tiles, dt])`` with ``dt =
    ceil(D / 128)`` and ``nsl = ceil(tr / 64)``: ``codes[i, t, r, k]`` is
    the code of ``x[i * tr + r, t * 128 + k]``, 0 past the tile's rows and
    past D. ``to_core_tiles(codes.view(-1, 64, 128))`` is the byte order the
    card writes, one ``[64, 128]`` piece per 64-row slice of a chunk."""
    rows, D = x.shape
    dt = max(_cdiv(D, SDDMM_DEPTH), 1)
    nsl = _cdiv(tr, 64)
    xp = F.pad(x.float(), (0, dt * SDDMM_DEPTH - D, 0, n_tiles * tr - rows))
    q, s = quant_tile(xp, tr, SDDMM_DEPTH)
    q = q.view(n_tiles, tr, dt, SDDMM_DEPTH).transpose(1, 2)
    codes = torch.zeros((n_tiles, dt, nsl * 64, SDDMM_DEPTH),
                        dtype=torch.int8, device=x.device)
    codes[:, :, :tr] = q
    return codes, s


def bsr_sddmm_panel_int8_plain(block_cols, nblocks, lhs, rhs, mask):
    """Plain version: ``lhs`` / ``rhs`` quantised per ``[bm, 128]`` /
    ``[bk, 128]`` tile (``sddmm_quant_plain``), one exact integer product
    per 128-deep chunk, rescaled and summed in f32; masked and padded slots
    are exact 0."""
    mb, max_bpr, bm, bk = mask.shape
    kb = max(_cdiv(rhs.shape[0], bk), 1)
    lq, ls = sddmm_quant_plain(lhs, bm, mb)       # [mb, dt, *, 128], [mb, dt]
    rq, rs = sddmm_quant_plain(rhs, bk, kb)
    lq, rq = lq[:, :, :bm].double(), rq[:, :, :bk].double()
    cols = block_cols.view(mb, max_bpr).long()
    live = ((torch.arange(max_bpr, device=lhs.device)[None, :]
             < nblocks.long()[:, None]) & (cols < kb))
    cols = cols.clamp(max=kb - 1)
    acc = torch.zeros(mask.shape, device=lhs.device)
    for t in range(ls.shape[1]):
        prod = torch.einsum("imd,iskd->ismk", lq[:, t],
                            rq[:, t][cols]).float()
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
    if mb * max_bpr > 65535:
        raise ValueError("grid too large for one launch")
    # the pre-pass's codes (lhs's, then rhs's; 64 x 128 bytes a 64-row
    # slice of a chunk) and scales (lhs's [mb, dt], then rhs's [kb, dt])
    n_slices = mb * _cdiv(bm, 64) + kb * _cdiv(bk, 64)
    codes = torch.empty(n_slices * dt * 64 * SDDMM_DEPTH, device=dev,
                        dtype=torch.int8)
    scales = torch.empty((mb + kb) * dt, device=dev, dtype=torch.float32)
    err = library().sddmm_panel_int8(
        block_cols.data_ptr(), nblocks.data_ptr(), lhs.data_ptr(),
        rhs.data_ptr(), mask.data_ptr(), codes.data_ptr(),
        scales.data_ptr(), out.data_ptr(), mb, max_bpr, bm, bk, M, Nr, D,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bsr_sddmm_panel_int8")
    bsr_sddmm_panel_int8.launches += 1
    return out


bsr_sddmm_panel_int8.launches = 0
