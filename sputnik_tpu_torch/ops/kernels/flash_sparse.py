"""Sparse-flash attention forward: metadata builder, the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces ``sputnik_tpu/ops/pallas/flash_sparse.py:flash_sparse_attention_fwd``;
the kernel is ``csrc/flash_sparse_fwd.cu`` and runs 64 x 64 tiles. The plain
version runs the same blockwise online softmax at any tile size, and returns
the same row statistics (running max ``m`` and denominator ``l``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import check_operands, guard_no_grad
from ._build import check, library

__all__ = ["build_flash_meta", "flash_sparse_attention_fwd",
           "flash_sparse_attention_fwd_plain", "KERNEL_TILE"]

_NEG_LARGE = -1e30
KERNEL_TILE = 64   # the CUDA kernel's (bm, bk)


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
                  "B10 (flash_sparse_bwd_dq / _dkv / _fused)", q, k, v)
    if (bm, bk) != (KERNEL_TILE, KERNEL_TILE):
        raise ValueError(f"the CUDA kernel runs {KERNEL_TILE}x{KERNEL_TILE} "
                         f"tiles, got ({bm}, {bk})")
    if hd > 128:
        raise ValueError(f"head dim {hd} > 128 is not supported")
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
