"""Sparse-flash attention, forward and backward: the metadata builders, the
CUDA kernels' wrappers and their plain PyTorch versions.

Replaces six kernels of ``sputnik_tpu/ops/pallas/flash_sparse.py``:
``flash_sparse_attention_fwd`` (``csrc/flash_sparse_fwd.cu``) and the
backward ``flash_sparse_bwd_fused``, ``flash_sparse_bwd_dq`` and
``flash_sparse_bwd_dkv`` (``csrc/flash_sparse_bwd.cu``), and the
sequence-parallel ring's band steps ``flash_sparse_ring_band_fwd`` (B11a,
the forward's body carrying its accumulator and row statistics across key
bands) and ``flash_sparse_ring_band_bwd`` (B11b, the fused backward's body
carrying dq, dk and dv). The kernels run 64 x 64 tiles; the plain versions
run the same blockwise algebra at any tile size. The forward returns the
row statistics (running max ``m`` and denominator ``l``) the backward
recomputes the probabilities from.

The forward kernel (B9, and B11a on the same body) runs on the tensor
cores in split TF32 after a pre-pass that splits K and V once a call; where
the card would see too few walks, the host cuts each walk into chunks
(:func:`flash_split_tiles`) and a merge launch folds them
(:func:`flash_merge_plain` is its plain twin). The backward's row walk
(B10a, B10b, and B11b on the same body) does the same: a pre-pass splits K,
V and Kᵀ once a call, the five products of a tile run in split TF32, and a
split walk's partial dq are summed in chunk order by a merge launch
(:func:`flash_sparse_bwd_split_plain` is its plain twin). The column walk
(B10c) mirrors it: a pre-pass splits q·scale and dO and their transposes
once a call, the four products of a tile run in split TF32 with the keys
as M, dk / dv stay in registers, and a split
walk's partial dk / dv are summed in chunk order (:func:`flash_dkv_chunks`
is its plan, :func:`flash_sparse_bwd_dkv_split_plain` its plain twin). The
kernels take ``hd <= 128``; the plain versions run any head dim.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import SMS, check_operands, guard_no_grad
from ._build import check, library

__all__ = ["build_flash_meta", "build_flash_bwd_meta",
           "flash_sparse_attention_fwd", "flash_sparse_attention_fwd_plain",
           "flash_sparse_bwd_fused", "flash_sparse_bwd_fused_plain",
           "flash_sparse_bwd_dq", "flash_sparse_bwd_dq_plain",
           "flash_sparse_bwd_dkv", "flash_sparse_bwd_dkv_plain",
           "flash_sparse_ring_band_fwd", "flash_sparse_ring_band_fwd_plain",
           "flash_sparse_ring_band_bwd", "flash_sparse_ring_band_bwd_plain",
           "flash_sparse_ring_band_fwd_split_plain", "flash_merge_plain",
           "flash_sparse_bwd_split_plain", "flash_sparse_bwd_dkv_split_plain",
           "flash_split_tiles", "flash_dkv_chunks", "KERNEL_TILE",
           "SPLIT_CTAS"]

_NEG_LARGE = -1e30
KERNEL_TILE = 64   # the CUDA kernels' (bm, bk)
SPLIT_CTAS = 2 * SMS   # blocks a split walk aims for: two resident walks
                       # (hd <= 64) on each SM, forward and backward
MIN_SPLIT_TILES = 2    # the shortest chunk of a split walk, in slots
MAX_SPLIT_CHUNKS = 32  # the most chunks the merge launch folds (a warp's)


def flash_split_tiles(walks: int, max_bpr: int) -> int:
    """Slots a chunk of the split walks (B9, B11a; B10a, B10b, B11b; B10c
    with ``max_bpr`` its longest walk, ``group * max_bpc``), from host
    ints: ``max_bpr`` (the longest walk: one launch, no merge), halved
    while ``walks`` times the chunks a walk still fit ``SPLIT_CTAS`` blocks,
    down to ``MIN_SPLIT_TILES`` and up to ``MAX_SPLIT_CHUNKS`` chunks."""
    tiles = max(int(max_bpr), 1)
    while tiles > MIN_SPLIT_TILES:
        half = -(-tiles // 2)
        chunks = -(-max_bpr // half)
        if walks * chunks > SPLIT_CTAS or chunks > MAX_SPLIT_CHUNKS:
            break
        tiles = half
    return tiles


def _fwd_workspace(R, group, mb, s_kv, hd, max_bpr, tiles, device):
    """The forward kernel's workspace (``csrc/flash_sparse_fwd.cu``): K and
    V split, ``4 * 64 * HD`` floats a key block of each KV replica (HD = 64
    for hd <= 64, else 128), then, where the walk is split, each chunk's
    unnormalised state, ``R * mb * 64 * (HD + 2)`` floats a chunk."""
    hdp = 64 if hd <= 64 else 128
    n = (R // group) * -(-s_kv // KERNEL_TILE) * 4 * KERNEL_TILE * hdp
    if max_bpr > tiles:
        n += -(-max_bpr // tiles) * R * mb * KERNEL_TILE * (hdp + 2)
    return torch.empty(max(n, 1), device=device, dtype=torch.float32)


def _bwd_workspace(R, group, mb, s_kv, hd, max_bpr, tiles, device):
    """The row walk's workspace (``csrc/flash_sparse_bwd.cu``): K, V and Kᵀ
    split, ``3 * 2 * 64 * HD`` floats a key block of each KV replica, then,
    where the walk is split, each chunk's partial dq, ``R * mb * 64 * HD``
    floats a chunk."""
    hdp = 64 if hd <= 64 else 128
    n = (R // group) * -(-s_kv // KERNEL_TILE) * 6 * KERNEL_TILE * hdp
    if max_bpr > tiles:
        n += -(-max_bpr // tiles) * R * mb * KERNEL_TILE * hdp
    return torch.empty(max(n, 1), device=device, dtype=torch.float32)


def flash_dkv_chunks(nb: int, group: int, tiles: int):
    """The column walk's split plan for one key block (B10c): its walk is
    the group's query replicas one after another, ``nb`` slots each, and
    chunk ``c`` takes walk positions ``c * tiles ..`` up to the next
    chunk's. Returns each chunk's ``(replica in the group, slot)`` pairs, in
    walk order; the kernel launches ``ceil(group * max_bpc / tiles)``
    chunks a walk, those past this walk's length empty."""
    walk = [(gi, u) for gi in range(group) for u in range(nb)]
    return [walk[lo:lo + tiles] for lo in range(0, len(walk), tiles)]


def _dkv_workspace(R, group, mb, kb, hd, longest, tiles, device):
    """The column walk's workspace (``csrc/flash_sparse_bwd.cu``): each
    row block's record (q·scale and dO split, both transposed, m / l / D),
    ``R * mb * (8 * 64 * HD + 3 * 64)`` floats, then, where the walk is
    split, each chunk's partial dk and dv, ``2 * (R // group) * kb * 64 *
    HD`` floats a chunk."""
    hdp = 64 if hd <= 64 else 128
    n = R * mb * (8 * KERNEL_TILE * hdp + 3 * KERNEL_TILE)
    if longest > tiles:
        n += -(-longest // tiles) * 2 * (R // group) * kb * KERNEL_TILE * hdp
    return torch.empty(max(n, 1), device=device, dtype=torch.float32)


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


def _online_softmax_plain(block_cols, nblocks, mask_slot, is_partial, pmask,
                          q, k, v, carry, *, heads, max_bpr, scale, group,
                          chunk=None):
    """The forward kernel's blockwise online softmax from the carry
    ``(acc [R, mb, bm, hd], m, l [R, mb, bm])`` (``None``: zeros and
    -1e30), vectorised over replicas and row blocks, one step per block
    slot (``chunk = (lo, hi)``: those slots alone, one chunk of a split
    walk). Returns the advanced carry, ``acc`` unnormalised."""
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

    if carry is None:
        acc = q.new_zeros((R, mb, bm, hd))
        m = q.new_full((R, mb, bm), _NEG_LARGE)
        l = q.new_zeros((R, mb, bm))
    else:
        acc, m, l = carry
    lo, hi = (0, max_bpr) if chunk is None else chunk
    for s in range(lo, min(hi, max_bpr)):
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
    return acc, m, l


def flash_sparse_attention_fwd_plain(block_cols, nblocks, mask_slot,
                                     is_partial, pmask, q, k, v, *,
                                     heads: int, max_bpr: int, scale: float,
                                     group: int = 1):
    """Plain version: the kernel's blockwise online softmax, vectorised
    over replicas and row blocks, one step per block slot."""
    R, s_q, hd = q.shape
    acc, m, l = _online_softmax_plain(
        block_cols, nblocks, mask_slot, is_partial, pmask, q, k, v, None,
        heads=heads, max_bpr=max_bpr, scale=scale, group=group)
    out = acc / l.clamp(min=1e-30)[..., None]
    return (out.reshape(R, -1, hd)[:, :s_q], m.reshape(R, -1),
            l.reshape(R, -1))


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
    tiles = flash_split_tiles(R * mb, max_bpr)
    work = _fwd_workspace(R, group, mb, k.shape[1], hd, max_bpr, tiles, dev)
    err = library().flash_sparse_fwd_f32(
        block_cols.data_ptr(), nblocks.data_ptr(), mask_slot.data_ptr(),
        is_partial.data_ptr(), pmask.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
        work.data_ptr(), R, heads, group, mb, max_bpr, n_partial, s_q,
        k.shape[1], hd, tiles, float(scale),
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
                    v, g, m, l, D, *, heads, max_bpr, scale, group, want_kv,
                    chunk=None):
    """The row walk, vectorised over replicas and row blocks, one step per
    block slot (``chunk = (lo, hi)``: those slots alone, one chunk of a
    split walk)."""
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
    lo, hi = (0, max_bpr) if chunk is None else chunk
    for s in range(lo, min(hi, max_bpr)):
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


def flash_sparse_bwd_split_plain(block_cols, nblocks, mask_slot, is_partial,
                                 pmask, q, k, v, g, m, l, D, *, heads: int,
                                 max_bpr: int, scale: float, tiles: int,
                                 group: int = 1):
    """Plain twin of the row walk's split plan (B10a, B10b, B11b): each chunk
    of ``tiles`` slots walked on its own, its partial dq summed into dq in
    chunk order (the merge launch's order; p uses the forward's final m and
    l, so no chunk needs a rescale), dk / dv summed over the chunks.
    Returns ``(dq, dk, dv)``."""
    dq = dk = dv = None
    for lo in range(0, max(max_bpr, 1), tiles):
        part = _bwd_rows_plain(
            block_cols, nblocks, mask_slot, is_partial, pmask, q, k, v, g, m,
            l, D, heads=heads, max_bpr=max_bpr, scale=scale, group=group,
            want_kv=True, chunk=(lo, lo + tiles))
        if dq is None:
            dq, dk, dv = (torch.zeros_like(x) for x in part)
        dq, dk, dv = dq + part[0], dk + part[1], dv + part[2]
    return dq, dk, dv


def flash_sparse_bwd_dq_plain(block_cols, nblocks, mask_slot, is_partial,
                              pmask, q, k, v, g, m, l, D, *, heads: int,
                              max_bpr: int, scale: float, group: int = 1):
    """Plain version of the dq kernel: the row walk, dq only."""
    return _bwd_rows_plain(block_cols, nblocks, mask_slot, is_partial, pmask,
                           q, k, v, g, m, l, D, heads=heads, max_bpr=max_bpr,
                           scale=scale, group=group, want_kv=False)


def flash_sparse_bwd_dkv_plain(t_src_i, t_nblocks, t_mask_slot, t_is_partial,
                               pmask, q, k, v, g, m, l, D, *, heads: int,
                               max_bpc: int, scale: float, group: int = 1,
                               chunk=None):
    """Plain version of the dk/dv kernel: the transposed (column) walk,
    vectorised over replicas and column blocks, one step per slot
    (``chunk = (lo, hi)``: those positions of each walk alone, one chunk of
    a split walk; position ``gi * nb + u`` is slot ``u`` of the group's
    ``gi``-th query replica)."""
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
    first = (ridx % group)[:, None] * tn                      # [R, kb]
    r2 = ridx[:, None]
    dk = q.new_zeros((R, kb, bk, hd))
    dv = q.new_zeros((R, kb, bk, hd))
    for u in range(max_bpc):
        i = src[:, :, u]
        qq, gg = q_t[r2, i], g_t[r2, i]                       # [R,kb,bm,hd]
        pm = pmask[bidx[:, None], slots[:, :, u]]
        skip = u >= tn
        if chunk is not None:
            skip = skip | (first + u < chunk[0]) | (first + u >= chunk[1])
        dead = (skip[..., None, None]
                | (part[:, :, u, None, None] & (pm == 0)))
        p, ds = _recompute(qq @ k_r.transpose(-1, -2),
                           gg @ v_r.transpose(-1, -2), dead, m_t[r2, i],
                           l_t[r2, i], d_t[r2, i])
        dk = dk + ds.transpose(-1, -2) @ qq
        dv = dv + p.transpose(-1, -2) @ gg
    return _group_sum(dk, group, s_kv), _group_sum(dv, group, s_kv)


def flash_sparse_bwd_dkv_split_plain(t_src_i, t_nblocks, t_mask_slot,
                                     t_is_partial, pmask, q, k, v, g, m, l, D,
                                     *, heads: int, max_bpc: int,
                                     scale: float, tiles: int,
                                     group: int = 1):
    """Plain twin of the column walk's split plan (B10c): each chunk of
    ``tiles`` walk positions (:func:`flash_dkv_chunks`) walked on its own,
    its partial dk / dv summed in chunk order (the merge launch's order).
    Returns ``(dk, dv)``."""
    dk = dv = None
    for lo in range(0, max(group * max_bpc, 1), tiles):
        pk, pv = flash_sparse_bwd_dkv_plain(
            t_src_i, t_nblocks, t_mask_slot, t_is_partial, pmask, q, k, v, g,
            m, l, D, heads=heads, max_bpc=max_bpc, scale=scale, group=group,
            chunk=(lo, lo + tiles))
        dk = pk if dk is None else dk + pk
        dv = pv if dv is None else dv + pv
    return dk, dv


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


def _bwd_col_operands(name, t_src_i, t_nblocks, t_mask_slot, t_is_partial,
                      pmask, q, k, v, g, m, l, D, max_bpc):
    B, kb = t_nblocks.shape
    _, _, bm, bk = pmask.shape
    _check_kernel_shape(bm, bk, q.shape[2])
    i32, f32 = torch.int32, torch.float32
    check_operands(name, q.device, t_src_i=(t_src_i, i32),
                   t_nblocks=(t_nblocks, i32), t_mask_slot=(t_mask_slot, i32),
                   t_is_partial=(t_is_partial, i32), pmask=(pmask, f32),
                   q=(q, f32), k=(k, f32), v=(v, f32), g=(g, f32),
                   m=(m, f32), l=(l, f32), D=(D, f32))
    if (t_src_i.shape != (B, kb * max_bpc)
            or t_mask_slot.shape != t_src_i.shape
            or t_is_partial.shape != t_src_i.shape):
        raise ValueError("transposed metadata shapes disagree")


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
    tiles = flash_split_tiles(R * mb, max_bpr)
    work = _bwd_workspace(R, group, mb, k.shape[1], hd, max_bpr, tiles,
                          q.device)
    err = library().flash_sparse_bwd_fused_f32(
        block_cols.data_ptr(), nblocks.data_ptr(), mask_slot.data_ptr(),
        is_partial.data_ptr(), pmask.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), g.data_ptr(), m.data_ptr(), l.data_ptr(), D.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(), R,
        heads, group, mb, max_bpr, pmask.shape[1], s_q, k.shape[1], hd,
        tiles, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
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
    tiles = flash_split_tiles(R * mb, max_bpr)
    work = _bwd_workspace(R, group, mb, k.shape[1], hd, max_bpr, tiles,
                          q.device)
    err = library().flash_sparse_bwd_dq_f32(
        block_cols.data_ptr(), nblocks.data_ptr(), mask_slot.data_ptr(),
        is_partial.data_ptr(), pmask.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), g.data_ptr(), m.data_ptr(), l.data_ptr(), D.data_ptr(),
        dq.data_ptr(), work.data_ptr(), R, heads, group, mb, max_bpr,
        pmask.shape[1], s_q, k.shape[1], hd, tiles, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_sparse_bwd_dq")
    flash_sparse_bwd_dq.launches += 1
    return dq


def flash_sparse_bwd_dkv(t_src_i, t_nblocks, t_mask_slot, t_is_partial,
                         pmask, q, k, v, g, m, l, D, *, heads: int,
                         max_bpc: int, scale: float, group: int = 1):
    """dk, dv of the two-kernel backward over the transposed (column) walk
    of :func:`build_flash_bwd_meta`, no atomics (the same bits from run to
    run, split walk or not): operands as :func:`flash_sparse_bwd_fused`,
    returns ``(dk, dv)`` f32[R // group, s_kv, hd]."""
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
    _bwd_col_operands("flash_sparse_bwd_dkv", t_src_i, t_nblocks,
                      t_mask_slot, t_is_partial, pmask, q, k, v, g, m, l, D,
                      max_bpc)
    R, s_q, hd = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    mb, longest = m.shape[1] // bm, group * max_bpc
    tiles = flash_split_tiles((R // group) * kb, longest)
    work = _dkv_workspace(R, group, mb, kb, hd, longest, tiles, q.device)
    err = library().flash_sparse_bwd_dkv_f32(
        t_src_i.data_ptr(), t_nblocks.data_ptr(), t_mask_slot.data_ptr(),
        t_is_partial.data_ptr(), pmask.data_ptr(), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), g.data_ptr(), m.data_ptr(), l.data_ptr(),
        D.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(), R,
        heads, group, mb, kb, max_bpc, n_partial, s_q, k.shape[1], hd, tiles,
        SMS, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_sparse_bwd_dkv")
    flash_sparse_bwd_dkv.launches += 1
    return dk, dv


flash_sparse_bwd_fused.launches = 0
flash_sparse_bwd_dq.launches = 0
flash_sparse_bwd_dkv.launches = 0


# ---------------------------------------------------------------------------
# The sequence-parallel ring's band steps. One band's metadata is one mask
# for every replica (block_cols / mask_slot / is_partial [mb * max_bpr],
# nblocks [mb], pmask [n_partial, bm, bk]: a band of RingFlashSpec's stacked
# tables), q comes pre-scaled and spans the shard's padded rows
# [R, mb * bm, hd], k / v are the band's keys [R // group, n_loc, hd]. Each
# step advances its carry IN PLACE, on the card and on the CPU alike.
# ---------------------------------------------------------------------------


def _band(block_cols, nblocks, mask_slot, is_partial, pmask):
    """One band's metadata as the B = 1 tables of the batched versions."""
    return (block_cols[None], nblocks[None], mask_slot[None],
            is_partial[None], pmask[None])


def _check_band(name, block_cols, nblocks, pmask, q, k, v, max_bpr, group):
    if any(t.dim() != 3 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must be rank 3")
    R, rows, hd = q.shape
    (mb,) = nblocks.shape
    bm = pmask.shape[-2]
    if rows != mb * bm:
        raise ValueError(f"{name}: q has {rows} rows, the band's row blocks "
                         f"{mb * bm}")
    if group < 1 or R % group:
        raise ValueError(f"{name}: group {group} must divide replicas {R}")
    if k.shape != (R // group, k.shape[1], hd) or v.shape != k.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)} with group "
                         f"{group}")
    if block_cols.shape != (mb * max_bpr,):
        raise ValueError(f"{name}: block_cols {tuple(block_cols.shape)} != "
                         f"({mb * max_bpr},)")
    if R > 65535:
        raise ValueError("grid too large for one launch")


def flash_sparse_ring_band_fwd_plain(block_cols, nblocks, mask_slot,
                                     is_partial, pmask, q, k, v, acc, m, l,
                                     *, max_bpr: int, group: int = 1):
    """Plain version of B11a: the carry ``(acc, m, l)`` advanced over the
    band, returned as new tensors."""
    R, rows, hd = q.shape
    bm = pmask.shape[-2]
    carry = (acc.reshape(R, -1, bm, hd), m.reshape(R, -1, bm),
             l.reshape(R, -1, bm))
    a, mm, ll = _online_softmax_plain(
        *_band(block_cols, nblocks, mask_slot, is_partial, pmask), q, k, v,
        carry, heads=R, max_bpr=max_bpr, scale=1.0, group=group)
    return a.reshape(R, rows, hd), mm.reshape(R, rows), ll.reshape(R, rows)


def flash_merge_plain(carry, parts):
    """The split walk's merge launch, in its order: the carry ``(acc, m,
    l)`` and the chunks' unnormalised states ``parts`` at M = the largest
    of their m, each rescaled by exp(m - M) and summed after the carry in
    chunk order; a part with m <= -5e29 (no kept score: l = 0, acc = 0) is
    skipped, so a row no chunk touched keeps the carry bit for bit.
    Returns ``(acc, m, l)``, unnormalised."""
    acc, m, l = carry
    big = m
    for _, mp, _ in parts:
        big = torch.maximum(big, mp)
    cc = torch.exp(m - big)
    acc, l = acc * cc[..., None], l * cc
    for a, mp, lp in parts:
        live = mp > _NEG_LARGE / 2
        wgt = torch.exp(mp - big)
        l = torch.where(live, l + lp * wgt, l)
        acc = torch.where(live[..., None], acc + a * wgt[..., None], acc)
    return acc, big, l


def flash_sparse_ring_band_fwd_split_plain(block_cols, nblocks, mask_slot,
                                           is_partial, pmask, q, k, v, acc,
                                           m, l, *, max_bpr: int, tiles: int,
                                           group: int = 1):
    """Plain twin of B11a's split walk: each chunk of ``tiles`` slots from
    the identity, then :func:`flash_merge_plain` with the carry. Returns
    the advanced carry as new tensors."""
    R, rows, hd = q.shape
    bm = pmask.shape[-2]
    meta = _band(block_cols, nblocks, mask_slot, is_partial, pmask)
    parts = [_online_softmax_plain(*meta, q, k, v, None, heads=R,
                                   max_bpr=max_bpr, scale=1.0, group=group,
                                   chunk=(lo, lo + tiles))
             for lo in range(0, max(max_bpr, 1), tiles)]
    a, mm, ll = flash_merge_plain(
        (acc.reshape(R, -1, bm, hd), m.reshape(R, -1, bm),
         l.reshape(R, -1, bm)), parts)
    return a.reshape(R, rows, hd), mm.reshape(R, rows), ll.reshape(R, rows)


def flash_sparse_ring_band_fwd(block_cols, nblocks, mask_slot, is_partial,
                               pmask, q, k, v, acc, m, l, *, max_bpr: int,
                               group: int = 1):
    """One ring step of sparse flash attention over one key band (B11a).

    Band metadata as above, q f32[R, mb * bm, hd] pre-scaled, k / v
    f32[R // group, n_loc, hd], and the carry: the unnormalised accumulator
    acc f32[R, mb * bm, hd] and the running max / denominator m, l
    f32[R, mb * bm] (seed them with 0 and -1e30 / 0). Advances the carry in
    place and returns it; after the last band the output is
    ``acc / max(l, 1e-30)``.
    """
    _check_band("flash_sparse_ring_band_fwd", block_cols, nblocks, pmask, q,
                k, v, max_bpr, group)
    R, rows, hd = q.shape
    if acc.shape != q.shape or m.shape != (R, rows) or l.shape != m.shape:
        raise ValueError("the carry does not match q")
    if not q.is_cuda:
        for t, new in zip((acc, m, l), flash_sparse_ring_band_fwd_plain(
                block_cols, nblocks, mask_slot, is_partial, pmask, q, k, v,
                acc, m, l, max_bpr=max_bpr, group=group)):
            t.copy_(new)
        return acc, m, l

    guard_no_grad("flash_sparse_ring_band_fwd",
                  "parallel.ring_flash_attention", q, k, v)
    _check_kernel_shape(pmask.shape[-2], pmask.shape[-1], hd)
    i32, f32 = torch.int32, torch.float32
    check_operands("flash_sparse_ring_band_fwd", q.device,
                   block_cols=(block_cols, i32), nblocks=(nblocks, i32),
                   mask_slot=(mask_slot, i32), is_partial=(is_partial, i32),
                   pmask=(pmask, f32), q=(q, f32), k=(k, f32), v=(v, f32),
                   acc=(acc, f32), m=(m, f32), l=(l, f32))
    mb = nblocks.shape[0]
    if R == 0 or mb == 0:
        return acc, m, l
    tiles = flash_split_tiles(R * mb, max_bpr)
    work = _fwd_workspace(R, group, mb, k.shape[1], hd, max_bpr, tiles,
                          q.device)
    err = library().flash_sparse_ring_fwd_f32(
        block_cols.data_ptr(), nblocks.data_ptr(), mask_slot.data_ptr(),
        is_partial.data_ptr(), pmask.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        work.data_ptr(), R, group, mb, max_bpr, pmask.shape[0], k.shape[1],
        hd, tiles, torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_sparse_ring_band_fwd")
    flash_sparse_ring_band_fwd.launches += 1
    return acc, m, l


def flash_sparse_ring_band_bwd_plain(block_cols, nblocks, mask_slot,
                                     is_partial, pmask, q, k, v, g, m, l, D,
                                     dq, dk, dv, *, max_bpr: int):
    """Plain version of B11b: the carries ``(dq, dk, dv)`` advanced by the
    band's gradients, returned as new tensors."""
    R = q.shape[0]
    gq, gk, gv = _bwd_rows_plain(
        *_band(block_cols, nblocks, mask_slot, is_partial, pmask), q, k, v,
        g, m, l, D, heads=R, max_bpr=max_bpr, scale=1.0, group=1,
        want_kv=True)
    return dq + gq, dk + gk, dv + gv


def flash_sparse_ring_band_bwd(block_cols, nblocks, mask_slot, is_partial,
                               pmask, q, k, v, g, m, l, D, dq, dk, dv, *,
                               max_bpr: int):
    """One ring-backward step over one key band (B11b), group 1 only.

    Band metadata, q (pre-scaled) and k / v as
    :func:`flash_sparse_ring_band_fwd` with ``R_kv = R``; g f32[R, mb * bm,
    hd]; the ring forward's FINAL m, l f32[R, mb * bm] and D = rowsum(g *
    out) f32[R, mb * bm]. Adds the band's dq (with respect to the pre-scaled
    q), dk and dv to the carries dq f32[R, mb * bm, hd] and dk, dv
    f32[R, n_loc, hd] in place and returns them. The kernel adds each
    tile's dk / dv with atomics, so their summation order varies from run
    to run.
    """
    name = "flash_sparse_ring_band_bwd"
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: group 1 only (k has {k.shape[0]} "
                         f"replicas, q {q.shape[0]}); a GQA ring runs the "
                         f"two-kernel backward")
    _check_band(name, block_cols, nblocks, pmask, q, k, v, max_bpr, 1)
    R, rows, hd = q.shape
    if (g.shape != q.shape or dq.shape != q.shape or dk.shape != k.shape
            or dv.shape != k.shape or m.shape != (R, rows)
            or l.shape != m.shape or D.shape != m.shape):
        raise ValueError(f"{name}: g, the statistics or the carries do not "
                         f"match q and k")
    if not q.is_cuda:
        for t, new in zip((dq, dk, dv), flash_sparse_ring_band_bwd_plain(
                block_cols, nblocks, mask_slot, is_partial, pmask, q, k, v,
                g, m, l, D, dq, dk, dv, max_bpr=max_bpr)):
            t.copy_(new)
        return dq, dk, dv

    guard_no_grad(name, "parallel.ring_flash_attention", q, k, v, g)
    _check_kernel_shape(pmask.shape[-2], pmask.shape[-1], hd)
    i32, f32 = torch.int32, torch.float32
    check_operands(name, q.device,
                   block_cols=(block_cols, i32), nblocks=(nblocks, i32),
                   mask_slot=(mask_slot, i32), is_partial=(is_partial, i32),
                   pmask=(pmask, f32), q=(q, f32), k=(k, f32), v=(v, f32),
                   g=(g, f32), m=(m, f32), l=(l, f32), D=(D, f32),
                   dq=(dq, f32), dk=(dk, f32), dv=(dv, f32))
    mb = nblocks.shape[0]
    if R == 0 or mb == 0:
        return dq, dk, dv
    tiles = flash_split_tiles(R * mb, max_bpr)
    work = _bwd_workspace(R, 1, mb, k.shape[1], hd, max_bpr, tiles,
                          q.device)
    err = library().flash_sparse_ring_bwd_f32(
        block_cols.data_ptr(), nblocks.data_ptr(), mask_slot.data_ptr(),
        is_partial.data_ptr(), pmask.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), g.data_ptr(), m.data_ptr(), l.data_ptr(), D.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(), R, mb,
        max_bpr, pmask.shape[0], k.shape[1], hd, tiles,
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, name)
    flash_sparse_ring_band_bwd.launches += 1
    return dq, dk, dv


flash_sparse_ring_band_fwd.launches = 0
flash_sparse_ring_band_bwd.launches = 0
