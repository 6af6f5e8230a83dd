"""Int8 sparse-flash attention, forward and backward: the CUDA kernels'
wrappers and their plain PyTorch versions.

Replaces three kernels of ``sputnik_tpu/ops/pallas/flash_sparse_int8.py``:
``flash_sparse_attention_fwd_int8`` (B18a, ``csrc/flash_sparse_int8.cu``)
and the backward ``flash_sparse_bwd_dq_int8`` (B18b) and
``flash_sparse_bwd_dkv_int8`` (B18c, both ``csrc/flash_sparse_int8_bwd.cu``).
They read B9's flash metadata (``BatchedPanelSpec.flash_meta`` and, for
B18c, ``flash_bwd_meta``); the forward returns B9's ``(out, m, l)`` and the
backward takes them as B10b / B10c do.

The quantisation grid is the TPU kernels' and part of the result:
``q * scale`` and ``g`` per ``[bm, hd]`` row block, ``k`` and ``v`` per
``[bk, hd]`` key block; the scores are the exact integer product
rescaled by ``q_s * k_s``; ``p = exp(sc - m_new)`` over the whole
``bk``-wide tile, ``l`` sums the unquantised ``p``, and PV takes
``p_q = clip(round(p * 127), 0, 127)`` rescaled by ``v_s / 127``. The
backward recomputes, per occupied tile and from the forward's ``m`` and
``l``, ``p = exp(sc - m) / max(l, 1e-30)`` (0 where ``sc <= -5e29``),
``dp = int(g_q v_q^T) * (g_s * v_s)`` and ``ds = p * (dp - D)``, which is
quantised per ``[bm, bk]`` tile; then ``dq += int(ds_q k_q) * (ds_s * k_s)``
(B18b, with respect to ``q * scale``), ``dk += int(ds_q^T q_q) * (ds_s *
q_s)`` and ``dv += int(p_q^T g_q) * (g_s / 127)`` (B18c). The kernels run
64 x 64 tiles and raise on any other, since another tile would be another
grid; the plain versions run any tile.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import check_operands, guard_no_grad
from ._build import check, library
from .bsr_spmm_int8 import div127, quant_tile
from .flash_sparse import (_bwd_col_operands, _bwd_row_operands, _check_bwd,
                           _check_kernel_shape)

__all__ = ["flash_sparse_attention_fwd_int8",
           "flash_sparse_attention_fwd_int8_plain", "quant_kv_plain",
           "quant_rows_plain", "row_record_bytes",
           "flash_sparse_bwd_dq_int8", "flash_sparse_bwd_dq_int8_plain",
           "flash_sparse_bwd_dkv_int8", "flash_sparse_bwd_dkv_int8_plain"]

_NEG_LARGE = -1e30
_QAT = "int8.attention_qat"   # the autograd op over these kernels


def _quant_blocks(x, n_blocks, rows):
    """``x [R, s, hd]`` zero-padded to ``n_blocks * rows`` rows per replica
    and quantised per ``[rows, hd]`` block: float64 codes ``[R, n_blocks,
    rows, hd]`` and scales ``[R, n_blocks]``."""
    R, s, hd = x.shape
    xp = F.pad(x.float(), (0, 0, 0, n_blocks * rows - s))
    q, sc = quant_tile(xp.reshape(R * n_blocks * rows, hd), rows, hd)
    return q.double().view(R, n_blocks, rows, hd), sc.view(R, n_blocks)


def quant_kv_plain(k, v, hdp: int):
    """Plain twin of B18a's pre-pass (``quant_kv_kernel``): ``k, v [R, s_kv,
    hd]`` quantised per 64-key block, the head dims zero-padded to ``hdp``
    (64 or 128). Returns ``(k_codes int8 [R, kb, 64, hdp], v_codes_t int8
    [R, kb, hdp, 64], scales f32 [R, kb, 2])``: K's codes K-major along the
    head dim, V's transposed (K-major along the keys), and ``(k_s, v_s)``
    per block. ``bsr_spmm_int8.to_core_tiles`` of ``k_codes.view(-1, 64,
    hdp)`` (of ``v_codes_t.view(-1, hdp, 64)``) is the byte order the card
    writes."""
    R, s_kv, hd = k.shape
    kb = max(-(-s_kv // 64), 1)
    kq, ks = _quant_blocks(k, kb, 64)
    vq, vs = _quant_blocks(v, kb, 64)
    kq = F.pad(kq, (0, hdp - hd)).to(torch.int8)
    vq = F.pad(vq, (0, hdp - hd)).to(torch.int8)
    return kq, vq.transpose(-1, -2).contiguous(), torch.stack([ks, vs], -1)


def row_record_bytes(hd: int) -> int:
    """Bytes of one row block's record in B18c's pre-pass
    (``quant_rows_kernel``): the codes of ``q * scale`` and ``g``, K-major
    and transposed, ``4 * 64 * HD``, then ``m``, ``max(l, 1e-30)``, ``D``
    and the two scales in f32, rounded up to 128 (HD = 64 for hd <= 64,
    else 128)."""
    hdp = 64 if hd <= 64 else 128
    return -(-(4 * 64 * hdp + (3 * 64 + 2) * 4) // 128) * 128


def quant_rows_plain(q, g, scale: float, mb: int, hdp: int):
    """Plain twin of B18c's pre-pass (``quant_rows_kernel``): ``q * scale``
    and ``g`` ``[R, s_q, hd]`` quantised per 64-row block, the rows
    zero-padded to ``mb * 64`` and the head dims to ``hdp`` (64 or 128).
    Returns ``(q_codes, g_codes int8 [R, mb, 64, hdp], q_codes_t, g_codes_t
    int8 [R, mb, hdp, 64], scales f32 [R, mb, 2])``: the codes K-major
    along the head dim (the score products' B) and transposed, K-major
    along the rows (the gradient products' B), and ``(q_s, g_s)`` per
    block. ``bsr_spmm_int8.to_core_tiles`` of a ``[64, hdp]`` (``[hdp,
    64]``) block is the byte order the card writes."""
    qq, qs = _quant_blocks(q.float() * scale, mb, 64)
    gq, gs = _quant_blocks(g, mb, 64)
    pad = hdp - q.shape[2]
    qq = F.pad(qq, (0, pad)).to(torch.int8)
    gq = F.pad(gq, (0, pad)).to(torch.int8)
    return (qq, gq, qq.transpose(-1, -2).contiguous(),
            gq.transpose(-1, -2).contiguous(), torch.stack([qs, gs], -1))


def flash_sparse_attention_fwd_int8_plain(block_cols, nblocks, mask_slot,
                                          is_partial, pmask, q, k, v, *,
                                          heads: int, max_bpr: int,
                                          scale: float):
    """Plain version: the kernel's blockwise int8 online softmax, vectorised
    over replicas and row blocks, one step per block slot; the integer
    products in float64, exact."""
    B, _, bm, bk = pmask.shape
    mb = nblocks.shape[1]
    R, s_q, hd = q.shape
    kb = max(-(-k.shape[1] // bk), 1)
    dev = q.device
    ridx = torch.arange(R, device=dev)
    bidx = ridx // heads
    r2 = ridx[:, None]
    q_q, q_s = _quant_blocks(q.float() * scale, mb, bm)
    k_q, k_s = _quant_blocks(k, kb, bk)
    v_q, v_s = _quant_blocks(v, kb, bk)
    cols = block_cols.long().view(B, mb, max_bpr)[bidx]
    slots = mask_slot.long().view(B, mb, max_bpr)[bidx]
    part = is_partial.view(B, mb, max_bpr)[bidx] != 0
    nblk = nblocks.long()[bidx]                               # [R, mb]

    m = torch.full((R, mb, bm), _NEG_LARGE, device=dev)
    l = torch.zeros((R, mb, bm), device=dev)
    acc = torch.zeros((R, mb, bm, hd), device=dev)
    for s in range(max_bpr):
        c = cols[:, :, s]                                     # [R, mb]
        sc = (q_q @ k_q[r2, c].transpose(-1, -2)).float() * (
            q_s * k_s[r2, c])[..., None, None]                # [R,mb,bm,bk]
        pm = pmask[bidx[:, None], slots[:, :, s]]
        sc = torch.where(part[:, :, s, None, None] & (pm == 0), _NEG_LARGE, sc)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        p = torch.where(sc <= _NEG_LARGE / 2, 0.0, p)
        corr = torch.exp(m - m_new)
        live = (s < nblk)[..., None]                          # [R, mb, 1]
        l = torch.where(live, l * corr + p.sum(-1), l)
        p_q = torch.clamp(torch.round(p * 127.0), 0, 127)
        pv = (p_q.double() @ v_q[r2, c]).float()
        acc = torch.where(
            live[..., None],
            acc * corr[..., None] + pv * div127(v_s[r2, c])[..., None, None],
            acc)
        m = torch.where(live, m_new, m)
    out = acc / l.clamp(min=1e-30)[..., None]
    return (out.reshape(R, mb * bm, hd)[:, :s_q], m.reshape(R, mb * bm),
            l.reshape(R, mb * bm))


def flash_sparse_attention_fwd_int8(block_cols, nblocks, mask_slot,
                                    is_partial, pmask, q, k, v, *, heads: int,
                                    max_bpr: int, scale: float):
    """Fused int8 sparse attention forward.

    Metadata as ``flash_sparse.build_flash_meta`` (device tensors), q
    f32[R, s_q, hd] (unscaled; ``q * scale`` is what is quantised) with
    ``R = B * heads``, k/v f32[R, s_kv, hd]. Returns ``(out [R, s_q, hd],
    m [R, mb*bm], l [R, mb*bm])`` as the fp32 forward does.
    """
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k and v must be rank 3")
    R, s_q, hd = q.shape
    B, mb = nblocks.shape
    _, n_partial, bm, bk = pmask.shape
    if R != B * heads:
        raise ValueError(f"replicas {R} != masks {B} x heads {heads}")
    if k.shape != (R, k.shape[1], hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if s_q > mb * bm:
        raise ValueError(f"q has {s_q} rows, the mask {mb * bm}")
    if not q.is_cuda:
        return flash_sparse_attention_fwd_int8_plain(
            block_cols, nblocks, mask_slot, is_partial, pmask, q, k, v,
            heads=heads, max_bpr=max_bpr, scale=scale)

    guard_no_grad("flash_sparse_attention_fwd_int8", _QAT, q, k, v)
    _check_kernel_shape(bm, bk, hd)
    dev = q.device
    i32, f32 = torch.int32, torch.float32
    check_operands("flash_sparse_attention_fwd_int8", dev,
                   block_cols=(block_cols, i32), nblocks=(nblocks, i32),
                   mask_slot=(mask_slot, i32), is_partial=(is_partial, i32),
                   pmask=(pmask, f32), q=(q, f32), k=(k, f32), v=(v, f32))
    if (block_cols.shape != (B, mb * max_bpr)
            or mask_slot.shape != block_cols.shape
            or is_partial.shape != block_cols.shape):
        raise ValueError("block metadata shapes disagree")
    if R > 65535:
        raise ValueError("grid too large for one launch")
    out = torch.empty_like(q)
    m = torch.empty((R, mb * bm), device=dev, dtype=f32)
    l = torch.empty((R, mb * bm), device=dev, dtype=f32)
    if R == 0 or mb == 0:
        return out, m, l
    # the pre-pass's scales f32 [R, kb, 2], then (128-byte aligned) the
    # codes int8 [R, kb, 2, 64 * HD] (csrc/flash_sparse_int8.cu)
    kb = -(-k.shape[1] // bk)
    head = -(-R * kb * 8 // 128) * 128
    work = torch.empty(head + R * kb * 2 * bk * (64 if hd <= 64 else 128),
                       device=dev, dtype=torch.int8)
    err = library().flash_sparse_fwd_int8(
        block_cols.data_ptr(), nblocks.data_ptr(), mask_slot.data_ptr(),
        is_partial.data_ptr(), pmask.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
        work.data_ptr(), R, heads, mb, max_bpr, n_partial, s_q, k.shape[1],
        hd, float(scale), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "flash_sparse_attention_fwd_int8")
    flash_sparse_attention_fwd_int8.launches += 1
    return out, m, l


flash_sparse_attention_fwd_int8.launches = 0


# ---------------------------------------------------------------------------
# Backward (B18b, B18c): B10b / B10c's walks with every contraction on int8
# codes. The plain versions form sc, p, dp and ds with the kernels'
# operations in the kernels' order (the scale product first, a true divide
# by max(l, 1e-30) and by 127), so every code they quantise is the
# kernels'.
# ---------------------------------------------------------------------------


def _bwd_tiles(q, g, m, l, D, scale, mb, bm):
    """The row-block side of the backward: codes and scales of ``q * scale``
    and ``g`` per ``[bm, hd]`` block, and ``m``, ``max(l, 1e-30)`` and
    ``D`` cut into ``[R, mb, bm]``."""
    R, s_q, _ = q.shape
    q_q, q_s = _quant_blocks(q.float() * scale, mb, bm)
    g_q, g_s = _quant_blocks(g, mb, bm)
    return (q_q, q_s, g_q, g_s, m.view(R, mb, bm),
            l.clamp(min=1e-30).view(R, mb, bm),
            F.pad(D, (0, mb * bm - s_q)).view(R, mb, bm))


def _tile_grads(sc, dp, dead, m, l, d):
    """``(p, ds_q, ds_s)`` of score tiles ``[..., bm, bk]``: ``p`` from the
    forward's stats, ``ds = p * (dp - D)`` quantised per tile (float64
    codes)."""
    sc = torch.where(dead, _NEG_LARGE, sc)
    p = torch.exp(sc - m[..., None]) / l[..., None]
    p = torch.where(sc <= _NEG_LARGE / 2, 0.0, p)
    ds = p * (dp - d[..., None])
    lead, (bm, bk) = ds.shape[:-2], ds.shape[-2:]
    ds_q, ds_s = quant_tile(ds.reshape(-1, bk), bm, bk)
    return p, ds_q.double().view(ds.shape), ds_s.view(lead)


def flash_sparse_bwd_dq_int8_plain(block_cols, nblocks, mask_slot,
                                   is_partial, pmask, q, k, v, g, m, l, D, *,
                                   heads: int, max_bpr: int, scale: float):
    """Plain version of B18b: the row walk, vectorised over replicas and row
    blocks, one step per block slot; the integer products in float64,
    exact."""
    B, _, bm, bk = pmask.shape
    mb = nblocks.shape[1]
    R, s_q, hd = q.shape
    kb = max(-(-k.shape[1] // bk), 1)
    dev = q.device
    ridx = torch.arange(R, device=dev)
    bidx = ridx // heads
    r2 = ridx[:, None]
    q_q, q_s, g_q, g_s, m_t, l_t, d_t = _bwd_tiles(q, g, m, l, D, scale, mb,
                                                   bm)
    k_q, k_s = _quant_blocks(k, kb, bk)
    v_q, v_s = _quant_blocks(v, kb, bk)
    cols = block_cols.long().view(B, mb, max_bpr)[bidx]
    slots = mask_slot.long().view(B, mb, max_bpr)[bidx]
    part = is_partial.view(B, mb, max_bpr)[bidx] != 0
    nblk = nblocks.long()[bidx]                               # [R, mb]
    dq = torch.zeros((R, mb, bm, hd), device=dev)
    for s in range(max_bpr):
        c = cols[:, :, s]                                     # [R, mb]
        kk = k_q[r2, c]                                       # [R,mb,bk,hd]
        sc = (q_q @ kk.transpose(-1, -2)).float() * (
            q_s * k_s[r2, c])[..., None, None]
        dp = (g_q @ v_q[r2, c].transpose(-1, -2)).float() * (
            g_s * v_s[r2, c])[..., None, None]
        pm = pmask[bidx[:, None], slots[:, :, s]]
        _, ds_q, ds_s = _tile_grads(
            sc, dp, part[:, :, s, None, None] & (pm == 0), m_t, l_t, d_t)
        step = (ds_q @ kk).float() * (ds_s * k_s[r2, c])[..., None, None]
        dq = torch.where((s < nblk)[..., None, None], dq + step, dq)
    return dq.reshape(R, mb * bm, hd)[:, :s_q]


def flash_sparse_bwd_dkv_int8_plain(t_src_i, t_nblocks, t_mask_slot,
                                    t_is_partial, pmask, q, k, v, g, m, l, D,
                                    *, heads: int, max_bpc: int,
                                    scale: float):
    """Plain version of B18c: the transposed (column) walk, vectorised over
    replicas and column blocks, one step per slot; the integer products in
    float64, exact."""
    B, _, bm, bk = pmask.shape
    kb = t_nblocks.shape[1]
    R, s_q, hd = q.shape
    s_kv = k.shape[1]
    mb = m.shape[1] // bm
    dev = q.device
    ridx = torch.arange(R, device=dev)
    bidx = ridx // heads
    r2 = ridx[:, None]
    q_q, q_s, g_q, g_s, m_t, l_t, d_t = _bwd_tiles(q, g, m, l, D, scale, mb,
                                                   bm)
    k_q, k_s = _quant_blocks(k, kb, bk)                       # [R,kb,bk,hd]
    v_q, v_s = _quant_blocks(v, kb, bk)
    src = t_src_i.long().view(B, kb, max_bpc)[bidx]           # [R,kb,max_bpc]
    slots = t_mask_slot.long().view(B, kb, max_bpc)[bidx]
    part = t_is_partial.view(B, kb, max_bpc)[bidx] != 0
    tn = t_nblocks.long()[bidx]                               # [R, kb]
    dk = torch.zeros((R, kb, bk, hd), device=dev)
    dv = torch.zeros((R, kb, bk, hd), device=dev)
    for u in range(max_bpc):
        i = src[:, :, u]                                      # [R, kb]
        qq, qs, gg, gs = q_q[r2, i], q_s[r2, i], g_q[r2, i], g_s[r2, i]
        sc = (qq @ k_q.transpose(-1, -2)).float() * (
            qs * k_s)[..., None, None]
        dp = (gg @ v_q.transpose(-1, -2)).float() * (
            gs * v_s)[..., None, None]
        pm = pmask[bidx[:, None], slots[:, :, u]]
        p, ds_q, ds_s = _tile_grads(
            sc, dp, part[:, :, u, None, None] & (pm == 0), m_t[r2, i],
            l_t[r2, i], d_t[r2, i])
        p_q = torch.clamp(torch.round(p * 127.0), 0, 127).double()
        live = (u < tn)[..., None, None]
        dk = torch.where(live, dk + (ds_q.transpose(-1, -2) @ qq).float() * (
            ds_s * qs)[..., None, None], dk)
        dv = torch.where(live, dv + (p_q.transpose(-1, -2) @ gg).float() *
                         div127(gs)[..., None, None], dv)
    return (dk.reshape(R, kb * bk, hd)[:, :s_kv],
            dv.reshape(R, kb * bk, hd)[:, :s_kv])



def flash_sparse_bwd_dq_int8(block_cols, nblocks, mask_slot, is_partial,
                             pmask, q, k, v, g, m, l, D, *, heads: int,
                             max_bpr: int, scale: float):
    """Int8 dq of the sparse-flash backward over the forward's row walk.

    Metadata as ``flash_sparse.build_flash_meta`` (device tensors); q
    (unscaled; ``q * scale`` is what is quantised), g f32[R, s_q, hd]; k, v
    f32[R, s_kv, hd]; m, l f32[R, mb*bm] as the int8 forward returns them;
    D = rowsum(g * out) f32[R, s_q]. Returns dq f32[R, s_q, hd] with
    respect to ``q * scale``.
    """
    B, mb = nblocks.shape
    _check_bwd(q, k, v, g, m, l, D, R_meta=B * heads, heads=heads, group=1,
               m_rows=mb * pmask.shape[2])
    if not q.is_cuda:
        return flash_sparse_bwd_dq_int8_plain(
            block_cols, nblocks, mask_slot, is_partial, pmask, q, k, v, g, m,
            l, D, heads=heads, max_bpr=max_bpr, scale=scale)

    guard_no_grad("flash_sparse_bwd_dq_int8", _QAT, q, k, v, g)
    _bwd_row_operands("flash_sparse_bwd_dq_int8", block_cols, nblocks,
                      mask_slot, is_partial, pmask, q, k, v, g, m, l, D,
                      max_bpr)
    R, s_q, hd = q.shape
    dq = torch.empty_like(q)
    if R == 0 or mb == 0:
        return dq
    err = library().flash_sparse_bwd_dq_int8(
        block_cols.data_ptr(), nblocks.data_ptr(), mask_slot.data_ptr(),
        is_partial.data_ptr(), pmask.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), g.data_ptr(), m.data_ptr(), l.data_ptr(), D.data_ptr(),
        dq.data_ptr(), R, heads, mb, max_bpr, pmask.shape[1], s_q,
        k.shape[1], hd, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_sparse_bwd_dq_int8")
    flash_sparse_bwd_dq_int8.launches += 1
    return dq


def flash_sparse_bwd_dkv_int8(t_src_i, t_nblocks, t_mask_slot, t_is_partial,
                              pmask, q, k, v, g, m, l, D, *, heads: int,
                              max_bpc: int, scale: float):
    """Int8 dk, dv of the sparse-flash backward over the transposed
    (column) walk of ``flash_sparse.build_flash_bwd_meta``, no atomics:
    operands as :func:`flash_sparse_bwd_dq_int8`, returns ``(dk, dv)``
    f32[R, s_kv, hd]."""
    B, kb = t_nblocks.shape
    _, n_partial, bm, bk = pmask.shape
    _check_bwd(q, k, v, g, m, l, D, R_meta=B * heads, heads=heads, group=1,
               m_rows=m.shape[1])
    if m.shape[1] % bm or kb * bk < k.shape[1]:
        raise ValueError("row statistics or column blocks do not match the "
                         "tiles")
    if not q.is_cuda:
        return flash_sparse_bwd_dkv_int8_plain(
            t_src_i, t_nblocks, t_mask_slot, t_is_partial, pmask, q, k, v, g,
            m, l, D, heads=heads, max_bpc=max_bpc, scale=scale)

    guard_no_grad("flash_sparse_bwd_dkv_int8", _QAT, q, k, v, g)
    _bwd_col_operands("flash_sparse_bwd_dkv_int8", t_src_i, t_nblocks,
                      t_mask_slot, t_is_partial, pmask, q, k, v, g, m, l, D,
                      max_bpc)
    R, s_q, hd = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    mb = m.shape[1] // bm
    work = torch.empty(max(R * mb * row_record_bytes(hd), 1),
                       device=q.device, dtype=torch.int8)
    err = library().flash_sparse_bwd_dkv_int8(
        t_src_i.data_ptr(), t_nblocks.data_ptr(), t_mask_slot.data_ptr(),
        t_is_partial.data_ptr(), pmask.data_ptr(), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), g.data_ptr(), m.data_ptr(), l.data_ptr(),
        D.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(), R,
        heads, mb, kb, max_bpc, n_partial, s_q, k.shape[1], hd, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_sparse_bwd_dkv_int8")
    flash_sparse_bwd_dkv_int8.launches += 1
    return dk, dv


flash_sparse_bwd_dq_int8.launches = 0
flash_sparse_bwd_dkv_int8.launches = 0
