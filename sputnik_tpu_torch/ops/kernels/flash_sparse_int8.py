"""Int8 sparse-flash attention forward: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``sputnik_tpu/ops/pallas/flash_sparse_int8.py:
flash_sparse_attention_fwd_int8`` (B18a); the kernel is
``csrc/flash_sparse_int8.cu``. It reads B9's flash metadata
(``BatchedPanelSpec.flash_meta``) and returns B9's ``(out, m, l)``.

The quantisation grid is the TPU kernel's and part of the result:
``q * scale`` per ``[bm, hd]`` row block (once per row block), ``k`` and
``v`` per ``[bk, hd]`` key block; the scores are the exact integer product
rescaled by ``q_s * k_s``; ``p = exp(sc - m_new)`` over the whole ``bk``-wide
tile, ``l`` sums the unquantised ``p``, and PV takes
``p_q = clip(round(p * 127), 0, 127)`` rescaled by ``v_s / 127``. The kernel
runs 64 x 64 tiles and raises on any other, since another tile would be
another grid; the plain version runs any tile.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import check_operands, guard_no_grad
from ._build import check, library
from .bsr_spmm_int8 import div127, quant_tile
from .flash_sparse import _check_kernel_shape

__all__ = ["flash_sparse_attention_fwd_int8",
           "flash_sparse_attention_fwd_int8_plain"]

_NEG_LARGE = -1e30


def _quant_blocks(x, n_blocks, rows):
    """``x [R, s, hd]`` zero-padded to ``n_blocks * rows`` rows per replica
    and quantised per ``[rows, hd]`` block: float64 codes ``[R, n_blocks,
    rows, hd]`` and scales ``[R, n_blocks]``."""
    R, s, hd = x.shape
    xp = F.pad(x.float(), (0, 0, 0, n_blocks * rows - s))
    q, sc = quant_tile(xp.reshape(R * n_blocks * rows, hd), rows, hd)
    return q.double().view(R, n_blocks, rows, hd), sc.view(R, n_blocks)


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

    guard_no_grad("flash_sparse_attention_fwd_int8", "int8.attention_qat",
                  q, k, v)
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
    err = library().flash_sparse_fwd_int8(
        block_cols.data_ptr(), nblocks.data_ptr(), mask_slot.data_ptr(),
        is_partial.data_ptr(), pmask.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(), R, heads,
        mb, max_bpr, n_partial, s_q, k.shape[1], hd, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "flash_sparse_attention_fwd_int8")
    flash_sparse_attention_fwd_int8.launches += 1
    return out, m, l


flash_sparse_attention_fwd_int8.launches = 0
