"""Sparse-flash attention, forward and backward: the metadata builders, the
CUDA kernels' wrappers and their plain PyTorch versions.

Replaces four kernels of ``sputnik_tpu/ops/pallas/flash_sparse.py``:
``flash_sparse_attention_fwd`` (``csrc/flash_sparse_fwd.cu``) and the
backward ``flash_sparse_bwd_fused``, ``flash_sparse_bwd_dq`` and
``flash_sparse_bwd_dkv`` (``csrc/flash_sparse_bwd.cu``). The kernels run
64 x 64 tiles; the plain versions run the same blockwise algebra at any tile
size. The forward returns the row statistics (running max ``m`` and
denominator ``l``) the backward recomputes the probabilities from.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import check_operands, guard_no_grad
from ._build import check, library

__all__ = ["build_flash_meta", "build_flash_bwd_meta",
           "flash_sparse_attention_fwd", "flash_sparse_attention_fwd_plain",
           "flash_sparse_bwd_fused", "flash_sparse_bwd_fused_plain",
           "flash_sparse_bwd_dq", "flash_sparse_bwd_dq_plain",
           "flash_sparse_bwd_dkv", "flash_sparse_bwd_dkv_plain",
           "KERNEL_TILE"]

_NEG_LARGE = -1e30
KERNEL_TILE = 64   # the CUDA kernels' (bm, bk)


def _check_kernel_shape(bm, bk, hd):
    if (bm, bk) != (KERNEL_TILE, KERNEL_TILE):
        raise ValueError(f"the CUDA kernels run {KERNEL_TILE}x{KERNEL_TILE} "
                         f"tiles, got ({bm}, {bk})")
    if hd > 128:
        raise ValueError(f"head dim {hd} > 128 is not supported")


def build_flash_meta(views):
    """Per-mask metadata for the fused kernel from same-shape BlockViews.

    Returns a dict of stacked arrays (B leading dim):
      block_cols   i32[B, mb*max_bpr]   (padding repeats last valid)
      nblocks      i32[B, mb]
      mask_slot    i32[B, mb*max_bpr]   slot into the compacted mask panel;
                                        full blocks repeat the previous slot
      is_partial   i32[B, mb*max_bpr]
      pmask        f32[B, n_partial_max, bm, bk] compacted partial masks
    Partial mask tiles are deduplicated per mask: causal and banded masks
    repeat a few patterns down the diagonal, so the table stays a few tiles
    instead of one per diagonal block.
    """
    B = len(views)
    v0 = views[0]
    mb, bm, bk = v0.mb, v0.bm, v0.bk
    max_bpr = max(v.max_bpr for v in views)

    cols = np.zeros((B, mb * max_bpr), np.int32)
    nblk = np.zeros((B, mb), np.int32)
    slot = np.zeros((B, mb * max_bpr), np.int32)
    part = np.zeros((B, mb * max_bpr), np.int32)
    pmasks = []
    n_partial_max = 1
    for b, v in enumerate(views):
        c = np.zeros((mb, max_bpr), np.int32)
        c[:, : v.max_bpr] = v.block_cols
        sl = np.zeros((mb, max_bpr), np.int32)
        pt = np.zeros((mb, max_bpr), np.int32)
        pm = []
        seen: dict = {}   # tile bytes -> compacted slot
        cur = 0
        for i in range(mb):
            nb = int(v.nblocks[i])
            if 0 < nb < max_bpr:
                c[i, nb:] = c[i, nb - 1]
            for s in range(max_bpr):
                if s < nb:
                    tile = v.mask[i, s]
                    if not tile.all():
                        key = tile.tobytes()
                        hit = seen.get(key)
                        if hit is None:
                            pm.append(tile.astype(np.float32))
                            hit = seen[key] = len(pm) - 1
                        cur = hit
                        sl[i, s] = cur
                        pt[i, s] = 1
                    else:
                        sl[i, s] = cur
                else:
                    sl[i, s] = cur
        if not pm:
            pm = [np.ones((bm, bk), np.float32)]
        pmasks.append(np.stack(pm))
        n_partial_max = max(n_partial_max, len(pm))
        cols[b] = c.reshape(-1)
        nblk[b] = v.nblocks
        slot[b] = sl.reshape(-1)
        part[b] = pt.reshape(-1)

    pmask = np.zeros((B, n_partial_max, bm, bk), np.float32)
    for b, pm in enumerate(pmasks):
        pmask[b, : pm.shape[0]] = pm
    return dict(block_cols=cols, nblocks=nblk, mask_slot=slot,
                is_partial=part, pmask=pmask, max_bpr=int(max_bpr),
                mb=mb, bm=bm, bk=bk)


def build_flash_bwd_meta(views):
    """The forward metadata plus the transposed (column) walk the dk/dv
    kernel reads: for each block column ``j``, the source row blocks of its
    tiles and their mask slots.

    Adds to :func:`build_flash_meta`'s dict (B leading dim):
      t_src_i       i32[B, kb*max_bpc]  source row block (padding repeats
                                        the last valid one)
      t_nblocks     i32[B, kb]
      t_mask_slot   i32[B, kb*max_bpc]  the source tile's ``mask_slot``
      t_is_partial  i32[B, kb*max_bpc]  0 on padding slots
      max_bpc       int
    """
    B = len(views)
    v0 = views[0]
    kb = v0.kb
    metas = [v.transpose_meta() for v in views]
    max_bpc = max(ts.shape[1] for _, ts in metas)
    ti = np.zeros((B, kb * max_bpc), np.int32)
    tn = np.zeros((B, kb), np.int32)
    tslot = np.zeros((B, kb * max_bpc), np.int32)
    tpart = np.zeros((B, kb * max_bpc), np.int32)
    fmeta = build_flash_meta(views)
    mb = v0.mb
    max_bpr = fmeta["max_bpr"]
    for b, (tnb, tsrc) in enumerate(metas):
        pad = np.zeros((kb, max_bpc, 2), np.int32)
        pad[:, : tsrc.shape[1]] = tsrc
        for j in range(kb):
            nb = int(tnb[j])
            if 0 < nb < max_bpc:
                pad[j, nb:] = pad[j, nb - 1]
        ti[b] = pad[:, :, 0].reshape(-1)
        tn[b] = tnb
        sl = fmeta["mask_slot"][b].reshape(mb, max_bpr)
        pt = fmeta["is_partial"][b].reshape(mb, max_bpr)
        for j in range(kb):
            for u in range(max_bpc):
                i_src, s_src = pad[j, u]
                tslot[b, j * max_bpc + u] = sl[i_src, s_src]
                tpart[b, j * max_bpc + u] = (
                    pt[i_src, s_src] if u < max(int(tnb[j]), 1) else 0)
    return dict(t_src_i=ti, t_nblocks=tn, t_mask_slot=tslot,
                t_is_partial=tpart, max_bpc=int(max_bpc), **fmeta)


def flash_sparse_attention_fwd_plain(block_cols, nblocks, mask_slot,
                                     is_partial, pmask, q, k, v, *,
                                     heads: int, max_bpr: int, scale: float,
                                     group: int = 1):
    """Plain version: the kernel's blockwise online softmax, vectorised
    over replicas and row blocks, one step per block slot."""
    B, _, bm, bk = pmask.shape
    mb = nblocks.shape[1]
    R, s_q, hd = q.shape
    s_kv = k.shape[1]
    kb = max(-(-s_kv // bk), 1)
    dev = q.device
    bidx = torch.arange(R, device=dev) // heads
    kidx = (torch.arange(R, device=dev) // group)[:, None]
    q_t = F.pad(q * scale, (0, 0, 0, mb * bm - s_q)).view(R, mb, bm, hd)
    k_t = F.pad(k, (0, 0, 0, kb * bk - s_kv)).view(-1, kb, bk, hd)
    v_t = F.pad(v, (0, 0, 0, kb * bk - s_kv)).view(-1, kb, bk, hd)
    cols = block_cols.long().view(B, mb, max_bpr)[bidx]
    slots = mask_slot.long().view(B, mb, max_bpr)[bidx]
    part = is_partial.view(B, mb, max_bpr)[bidx] != 0
    nblk = nblocks.long()[bidx]                               # [R, mb]

    m = q.new_full((R, mb, bm), _NEG_LARGE)
    l = q.new_zeros((R, mb, bm))
    acc = q.new_zeros((R, mb, bm, hd))
    for s in range(max_bpr):
        sc = q_t @ k_t[kidx, cols[:, :, s]].transpose(-1, -2)  # [R,mb,bm,bk]
        pm = pmask[bidx[:, None], slots[:, :, s]]
        sc = torch.where(part[:, :, s, None, None] & (pm == 0), _NEG_LARGE, sc)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        p = torch.where(sc <= _NEG_LARGE / 2, 0.0, p)
        corr = torch.exp(m - m_new)
        live = (s < nblk)[..., None]                          # [R, mb, 1]
        l = torch.where(live, l * corr + p.sum(-1), l)
        acc = torch.where(live[..., None],
                          acc * corr[..., None] + p @ v_t[kidx, cols[:, :, s]],
                          acc)
        m = torch.where(live, m_new, m)
    out = acc / l.clamp(min=1e-30)[..., None]
    return (out.reshape(R, mb * bm, hd)[:, :s_q], m.reshape(R, mb * bm),
            l.reshape(R, mb * bm))


def flash_sparse_attention_fwd(block_cols, nblocks, mask_slot, is_partial,
                               pmask, q, k, v, *, heads: int, max_bpr: int,
                               scale: float, group: int = 1):
    """Fused sparse attention forward.

    Metadata as :func:`build_flash_meta` (device tensors), q f32[R, s_q, hd]
    with ``R = B * heads``, k/v f32[R // group, s_kv, hd]. Returns
    ``(out [R, s_q, hd], m [R, mb*bm], l [R, mb*bm])``: the attention output
    and each row's running max and softmax denominator.
    """
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k and v must be rank 3")
    R, s_q, hd = q.shape
    B, mb = nblocks.shape
    _, n_partial, bm, bk = pmask.shape
    if R != B * heads:
        raise ValueError(f"replicas {R} != masks {B} x heads {heads}")
    if group < 1 or R % group or heads % group:
        raise ValueError(f"group {group} must divide heads {heads}")
    if k.shape != (R // group, k.shape[1], hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} with group {group}")
    if s_q > mb * bm:
        raise ValueError(f"q has {s_q} rows, the mask {mb * bm}")
    if not q.is_cuda:
        return flash_sparse_attention_fwd_plain(
            block_cols, nblocks, mask_slot, is_partial, pmask, q, k, v,
            heads=heads, max_bpr=max_bpr, scale=scale, group=group)

    guard_no_grad("flash_sparse_attention_fwd",
                  "fused_attention.fused_sparse_attention", q, k, v)
    _check_kernel_shape(bm, bk, hd)
    dev = q.device
    i32, f32 = torch.int32, torch.float32
    check_operands("flash_sparse_attention_fwd", dev,
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
    err = library().flash_sparse_fwd_f32(
        block_cols.data_ptr(), nblocks.data_ptr(), mask_slot.data_ptr(),
        is_partial.data_ptr(), pmask.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(), R, heads,
        group, mb, max_bpr, n_partial, s_q, k.shape[1], hd, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "flash_sparse_attention_fwd")
    flash_sparse_attention_fwd.launches += 1
    return out, m, l


flash_sparse_attention_fwd.launches = 0


# ---------------------------------------------------------------------------
# Backward. Each occupied tile's probabilities are recomputed from the
# forward's row statistics: p = exp(sc - m) / max(l, 1e-30), forced to 0
# where the (masked) score is <= -5e29, ds = p * (g v^T - D) with
# D = rowsum(g * out). dq is taken with respect to q * scale (the caller
# multiplies by scale); dk and dv are summed into their KV replica.
# ---------------------------------------------------------------------------


def _row_tiles(q, g, m, l, D, scale, mb, bm):
    """q * scale, g and the row statistics cut into ``[R, mb, bm, ...]``
    row blocks (rows past ``s_q`` are zero)."""
    R, s_q, hd = q.shape
    pad = mb * bm - s_q
    return (F.pad(q * scale, (0, 0, 0, pad)).view(R, mb, bm, hd),
            F.pad(g, (0, 0, 0, pad)).view(R, mb, bm, hd),
            m.view(R, mb, bm), l.clamp(min=1e-30).view(R, mb, bm),
            F.pad(D, (0, pad)).view(R, mb, bm))


def _recompute(sc, dp, dead, m, l, d):
    """``(p, ds)`` of score tiles ``sc`` (``dead``: masked or padded)."""
    sc = torch.where(dead, _NEG_LARGE, sc)
    p = torch.exp(sc - m[..., None]) / l[..., None]
    p = torch.where(sc <= _NEG_LARGE / 2, 0.0, p)
    return p, p * (dp - d[..., None])


def _group_sum(x, group, rows):
    """Per-query-replica ``[R, kb, bk, hd]`` -> KV replica ``[R // group,
    rows, hd]``."""
    R, kb, bk, hd = x.shape
    return x.view(R // group, group, kb * bk, hd).sum(1)[:, :rows]


def _bwd_rows_plain(block_cols, nblocks, mask_slot, is_partial, pmask, q, k,
                    v, g, m, l, D, *, heads, max_bpr, scale, group, want_kv):
    B, _, bm, bk = pmask.shape
    mb = nblocks.shape[1]
    R, s_q, hd = q.shape
    s_kv = k.shape[1]
    kb = max(-(-s_kv // bk), 1)
    dev = q.device
    ridx = torch.arange(R, device=dev)
    bidx = ridx // heads
    kidx = (ridx // group)[:, None]
    q_t, g_t, m_t, l_t, d_t = _row_tiles(q, g, m, l, D, scale, mb, bm)
    k_t = F.pad(k, (0, 0, 0, kb * bk - s_kv)).view(-1, kb, bk, hd)
    v_t = F.pad(v, (0, 0, 0, kb * bk - s_kv)).view(-1, kb, bk, hd)
    cols = block_cols.long().view(B, mb, max_bpr)[bidx]
    slots = mask_slot.long().view(B, mb, max_bpr)[bidx]
    part = is_partial.view(B, mb, max_bpr)[bidx] != 0
    nblk = nblocks.long()[bidx]                               # [R, mb]
    rows = ridx[:, None].expand(R, mb)
    dq = torch.zeros_like(q_t)
    dk = q.new_zeros((R, kb, bk, hd))
    dv = q.new_zeros((R, kb, bk, hd))
    for s in range(max_bpr):
        c = cols[:, :, s]
        kk, vv = k_t[kidx, c], v_t[kidx, c]                   # [R,mb,bk,hd]
        pm = pmask[bidx[:, None], slots[:, :, s]]
        dead = ((s >= nblk)[..., None, None]
                | (part[:, :, s, None, None] & (pm == 0)))
        p, ds = _recompute(q_t @ kk.transpose(-1, -2),
                           g_t @ vv.transpose(-1, -2), dead, m_t, l_t, d_t)
        dq = dq + ds @ kk
        if want_kv:
            dk.index_put_((rows, c), ds.transpose(-1, -2) @ q_t,
                          accumulate=True)
            dv.index_put_((rows, c), p.transpose(-1, -2) @ g_t,
                          accumulate=True)
    dq = dq.reshape(R, mb * bm, hd)[:, :s_q]
    if not want_kv:
        return dq
    return dq, _group_sum(dk, group, s_kv), _group_sum(dv, group, s_kv)


def flash_sparse_bwd_fused_plain(block_cols, nblocks, mask_slot, is_partial,
                                 pmask, q, k, v, g, m, l, D, *, heads: int,
                                 max_bpr: int, scale: float, group: int = 1):
    """Plain version of the single-pass backward: the row walk, vectorised
    over replicas and row blocks, one step per block slot."""
    return _bwd_rows_plain(block_cols, nblocks, mask_slot, is_partial, pmask,
                           q, k, v, g, m, l, D, heads=heads, max_bpr=max_bpr,
                           scale=scale, group=group, want_kv=True)


def flash_sparse_bwd_dq_plain(block_cols, nblocks, mask_slot, is_partial,
                              pmask, q, k, v, g, m, l, D, *, heads: int,
                              max_bpr: int, scale: float, group: int = 1):
    """Plain version of the dq kernel: the row walk, dq only."""
    return _bwd_rows_plain(block_cols, nblocks, mask_slot, is_partial, pmask,
                           q, k, v, g, m, l, D, heads=heads, max_bpr=max_bpr,
                           scale=scale, group=group, want_kv=False)


def flash_sparse_bwd_dkv_plain(t_src_i, t_nblocks, t_mask_slot, t_is_partial,
                               pmask, q, k, v, g, m, l, D, *, heads: int,
                               max_bpc: int, scale: float, group: int = 1):
    """Plain version of the dk/dv kernel: the transposed (column) walk,
    vectorised over replicas and column blocks, one step per slot."""
    B, _, bm, bk = pmask.shape
    kb = t_nblocks.shape[1]
    R, s_q, hd = q.shape
    s_kv = k.shape[1]
    mb = m.shape[1] // bm
    dev = q.device
    ridx = torch.arange(R, device=dev)
    bidx = ridx // heads
    q_t, g_t, m_t, l_t, d_t = _row_tiles(q, g, m, l, D, scale, mb, bm)
    k_r = F.pad(k, (0, 0, 0, kb * bk - s_kv)).view(-1, kb, bk, hd)[
        ridx // group]                                        # [R,kb,bk,hd]
    v_r = F.pad(v, (0, 0, 0, kb * bk - s_kv)).view(-1, kb, bk, hd)[
        ridx // group]
    src = t_src_i.long().view(B, kb, max_bpc)[bidx]           # [R,kb,max_bpc]
    slots = t_mask_slot.long().view(B, kb, max_bpc)[bidx]
    part = t_is_partial.view(B, kb, max_bpc)[bidx] != 0
    tn = t_nblocks.long()[bidx]                               # [R, kb]
    r2 = ridx[:, None]
    dk = q.new_zeros((R, kb, bk, hd))
    dv = q.new_zeros((R, kb, bk, hd))
    for u in range(max_bpc):
        i = src[:, :, u]
        qq, gg = q_t[r2, i], g_t[r2, i]                       # [R,kb,bm,hd]
        pm = pmask[bidx[:, None], slots[:, :, u]]
        dead = ((u >= tn)[..., None, None]
                | (part[:, :, u, None, None] & (pm == 0)))
        p, ds = _recompute(qq @ k_r.transpose(-1, -2),
                           gg @ v_r.transpose(-1, -2), dead, m_t[r2, i],
                           l_t[r2, i], d_t[r2, i])
        dk = dk + ds.transpose(-1, -2) @ qq
        dv = dv + p.transpose(-1, -2) @ gg
    return _group_sum(dk, group, s_kv), _group_sum(dv, group, s_kv)


def _check_bwd(q, k, v, g, m, l, D, *, R_meta, heads, group, m_rows):
    if any(t.dim() != 3 for t in (q, k, v, g)):
        raise ValueError("q, k, v and g must be rank 3")
    R, s_q, hd = q.shape
    if R != R_meta:
        raise ValueError(f"replicas {R} != masks x heads {R_meta}")
    if group < 1 or R % group or heads % group:
        raise ValueError(f"group {group} must divide heads {heads}")
    if (k.shape != (R // group, k.shape[1], hd) or v.shape != k.shape
            or g.shape != q.shape):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} / g "
                         f"{tuple(g.shape)} do not match q {tuple(q.shape)} "
                         f"with group {group}")
    if m.shape != (R, m_rows) or l.shape != m.shape or D.shape != (R, s_q):
        raise ValueError(f"m {tuple(m.shape)} / l {tuple(l.shape)} must be "
                         f"{(R, m_rows)} and D {tuple(D.shape)} {(R, s_q)}")
    if s_q > m_rows:
        raise ValueError(f"q has {s_q} rows, the mask {m_rows}")
    if R > 65535:
        raise ValueError("grid too large for one launch")


def _bwd_row_operands(name, block_cols, nblocks, mask_slot, is_partial,
                      pmask, q, k, v, g, m, l, D, max_bpr):
    B, mb = nblocks.shape
    _, _, bm, bk = pmask.shape
    _check_kernel_shape(bm, bk, q.shape[2])
    i32, f32 = torch.int32, torch.float32
    check_operands(name, q.device, block_cols=(block_cols, i32),
                   nblocks=(nblocks, i32), mask_slot=(mask_slot, i32),
                   is_partial=(is_partial, i32), pmask=(pmask, f32),
                   q=(q, f32), k=(k, f32), v=(v, f32), g=(g, f32),
                   m=(m, f32), l=(l, f32), D=(D, f32))
    if (block_cols.shape != (B, mb * max_bpr)
            or mask_slot.shape != block_cols.shape
            or is_partial.shape != block_cols.shape):
        raise ValueError("block metadata shapes disagree")


def flash_sparse_bwd_fused(block_cols, nblocks, mask_slot, is_partial, pmask,
                           q, k, v, g, m, l, D, *, heads: int, max_bpr: int,
                           scale: float, group: int = 1):
    """Single-pass sparse-flash backward over the forward's row walk.

    Metadata as :func:`build_flash_meta` (device tensors); q, g
    f32[R, s_q, hd]; k, v f32[R // group, s_kv, hd]; m, l f32[R, mb*bm] as
    the forward returns them; D = rowsum(g * out) f32[R, s_q]. Returns
    ``(dq [R, s_q, hd], dk, dv [R // group, s_kv, hd])`` with dq taken with
    respect to ``q * scale``. The kernel adds each tile's dk/dv with
    atomics, so their summation order varies from run to run.
    """
    B, mb = nblocks.shape
    _check_bwd(q, k, v, g, m, l, D, R_meta=B * heads, heads=heads,
               group=group, m_rows=mb * pmask.shape[2])
    if not q.is_cuda:
        return flash_sparse_bwd_fused_plain(
            block_cols, nblocks, mask_slot, is_partial, pmask, q, k, v, g, m,
            l, D, heads=heads, max_bpr=max_bpr, scale=scale, group=group)

    guard_no_grad("flash_sparse_bwd_fused",
                  "fused_attention.fused_sparse_attention", q, k, v, g)
    _bwd_row_operands("flash_sparse_bwd_fused", block_cols, nblocks,
                      mask_slot, is_partial, pmask, q, k, v, g, m, l, D,
                      max_bpr)
    R, s_q, hd = q.shape
    dq = torch.empty_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    if R == 0 or mb == 0:
        return dq, dk, dv
    err = library().flash_sparse_bwd_fused_f32(
        block_cols.data_ptr(), nblocks.data_ptr(), mask_slot.data_ptr(),
        is_partial.data_ptr(), pmask.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), g.data_ptr(), m.data_ptr(), l.data_ptr(), D.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), R, heads, group, mb,
        max_bpr, pmask.shape[1], s_q, k.shape[1], hd, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_sparse_bwd_fused")
    flash_sparse_bwd_fused.launches += 1
    return dq, dk, dv


def flash_sparse_bwd_dq(block_cols, nblocks, mask_slot, is_partial, pmask,
                        q, k, v, g, m, l, D, *, heads: int, max_bpr: int,
                        scale: float, group: int = 1):
    """dq of the two-kernel backward (row walk, no atomics): operands as
    :func:`flash_sparse_bwd_fused`, returns dq f32[R, s_q, hd] with respect
    to ``q * scale``."""
    B, mb = nblocks.shape
    _check_bwd(q, k, v, g, m, l, D, R_meta=B * heads, heads=heads,
               group=group, m_rows=mb * pmask.shape[2])
    if not q.is_cuda:
        return flash_sparse_bwd_dq_plain(
            block_cols, nblocks, mask_slot, is_partial, pmask, q, k, v, g, m,
            l, D, heads=heads, max_bpr=max_bpr, scale=scale, group=group)

    guard_no_grad("flash_sparse_bwd_dq",
                  "fused_attention.fused_sparse_attention", q, k, v, g)
    _bwd_row_operands("flash_sparse_bwd_dq", block_cols, nblocks, mask_slot,
                      is_partial, pmask, q, k, v, g, m, l, D, max_bpr)
    R, s_q, hd = q.shape
    dq = torch.empty_like(q)
    if R == 0 or mb == 0:
        return dq
    err = library().flash_sparse_bwd_dq_f32(
        block_cols.data_ptr(), nblocks.data_ptr(), mask_slot.data_ptr(),
        is_partial.data_ptr(), pmask.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), g.data_ptr(), m.data_ptr(), l.data_ptr(), D.data_ptr(),
        dq.data_ptr(), R, heads, group, mb, max_bpr, pmask.shape[1], s_q,
        k.shape[1], hd, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_sparse_bwd_dq")
    flash_sparse_bwd_dq.launches += 1
    return dq


def flash_sparse_bwd_dkv(t_src_i, t_nblocks, t_mask_slot, t_is_partial,
                         pmask, q, k, v, g, m, l, D, *, heads: int,
                         max_bpc: int, scale: float, group: int = 1):
    """dk, dv of the two-kernel backward over the transposed (column) walk
    of :func:`build_flash_bwd_meta`, no atomics: operands as
    :func:`flash_sparse_bwd_fused`, returns ``(dk, dv)`` f32[R // group,
    s_kv, hd]."""
    B, kb = t_nblocks.shape
    _, n_partial, bm, bk = pmask.shape
    _check_bwd(q, k, v, g, m, l, D, R_meta=B * heads, heads=heads,
               group=group, m_rows=m.shape[1])
    if m.shape[1] % bm or kb * bk < k.shape[1]:
        raise ValueError("row statistics or column blocks do not match the "
                         "tiles")
    if not q.is_cuda:
        return flash_sparse_bwd_dkv_plain(
            t_src_i, t_nblocks, t_mask_slot, t_is_partial, pmask, q, k, v, g,
            m, l, D, heads=heads, max_bpc=max_bpc, scale=scale, group=group)

    guard_no_grad("flash_sparse_bwd_dkv",
                  "fused_attention.fused_sparse_attention", q, k, v, g)
    R, s_q, hd = q.shape
    _check_kernel_shape(bm, bk, hd)
    i32, f32 = torch.int32, torch.float32
    check_operands("flash_sparse_bwd_dkv", q.device,
                   t_src_i=(t_src_i, i32), t_nblocks=(t_nblocks, i32),
                   t_mask_slot=(t_mask_slot, i32),
                   t_is_partial=(t_is_partial, i32), pmask=(pmask, f32),
                   q=(q, f32), k=(k, f32), v=(v, f32), g=(g, f32),
                   m=(m, f32), l=(l, f32), D=(D, f32))
    if (t_src_i.shape != (B, kb * max_bpc)
            or t_mask_slot.shape != t_src_i.shape
            or t_is_partial.shape != t_src_i.shape):
        raise ValueError("transposed metadata shapes disagree")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    err = library().flash_sparse_bwd_dkv_f32(
        t_src_i.data_ptr(), t_nblocks.data_ptr(), t_mask_slot.data_ptr(),
        t_is_partial.data_ptr(), pmask.data_ptr(), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), g.data_ptr(), m.data_ptr(), l.data_ptr(),
        D.data_ptr(), dk.data_ptr(), dv.data_ptr(), R, heads, group,
        m.shape[1] // bm, kb, max_bpc, n_partial, s_q, k.shape[1], hd,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_sparse_bwd_dkv")
    flash_sparse_bwd_dkv.launches += 1
    return dk, dv


flash_sparse_bwd_fused.launches = 0
flash_sparse_bwd_dq.launches = 0
flash_sparse_bwd_dkv.launches = 0
