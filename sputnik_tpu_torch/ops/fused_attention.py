"""Differentiable fused sparse attention (counterpart of
``sputnik_tpu/ops/fused_attention.py``).

``fused_sparse_attention(spec, q, k, v)`` computes masked softmax attention
over the score topology of ``spec`` without materialising the scores:

  * forward: one launch of the sparse-flash kernel for all replicas
    (``kernels/flash_sparse.py``), saving each row's max ``m`` and
    denominator ``l``;
  * backward: the kernels recompute the probabilities of each occupied tile
    from ``m``, ``l`` and ``D = rowsum(g * out)``. One pass over the row
    walk gives dq, dk and dv (``flash_sparse_bwd_fused``), or, above the
    accumulator budget, dq over the row walk and dk/dv over the transposed
    (column) walk (``flash_sparse_bwd_dq`` + ``flash_sparse_bwd_dkv``).

CPU tensors run the kernels' plain versions, so the CPU exercises the same
algebra the card runs.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .batched_panel import BatchedPanelSpec
from .kernels.flash_sparse import (flash_sparse_attention_fwd,
                                   flash_sparse_bwd_dkv, flash_sparse_bwd_dq,
                                   flash_sparse_bwd_fused)

__all__ = ["fused_sparse_attention", "warm_flash_meta"]

# The accumulator budget of the single-pass backward, under the JAX
# package's name and rule (``_use_fused_bwd``): two f32 dk/dv accumulators of
# ``n_pad x hd_pad`` (hd rounded up to 128 lanes) within 32 MiB. The figure
# is the TPU's VMEM budget, kept so both packages take the same route at the
# same shapes; the H100 kernel adds dk/dv with atomics and has no such
# bound, so the crossover is to be re-measured on the card.
_FUSED_BWD_ACC_BYTES = 32 * 1024 * 1024


def _hd_pad(hd: int) -> int:
    return -(-max(hd, 1) // 128) * 128


def _use_fused_bwd(spec: BatchedPanelSpec, hd_pad: int) -> bool:
    return 2 * spec.n_pad * hd_pad * 4 <= _FUSED_BWD_ACC_BYTES


def warm_flash_meta(spec: BatchedPanelSpec, device, *,
                    backward: bool = True, hd: int = 128) -> None:
    """Build the flash metadata of ``spec`` on ``device`` ahead of the first
    step. ``backward=False`` skips the backward's tables (inference); they
    are also skipped when the single-pass backward handles ``hd``, since it
    reads only the forward's metadata."""
    spec.flash_meta(device)
    if backward and not _use_fused_bwd(spec, _hd_pad(hd)):
        spec.flash_bwd_meta(device)


def _fused_fwd(spec: BatchedPanelSpec, q, k, v, scale: float, group: int):
    """-> ``(out [R, s, hd], m [R, m_pad], l [R, m_pad])``."""
    meta = spec.flash_meta(q.device)
    return flash_sparse_attention_fwd(
        meta["block_cols"], meta["nblocks"], meta["mask_slot"],
        meta["is_partial"], meta["pmask"], q.contiguous(), k.contiguous(),
        v.contiguous(), heads=spec.heads, max_bpr=meta["max_bpr"],
        scale=scale, group=group)


def _fused_bwd(spec: BatchedPanelSpec, q, k, v, g, m, l, D, scale: float,
               group: int):
    """-> ``(dq, dk, dv)``; dq with respect to ``q * scale``."""
    kw = dict(heads=spec.heads, scale=scale, group=group)
    if _use_fused_bwd(spec, _hd_pad(q.shape[-1])):
        meta = spec.flash_meta(q.device)
        return flash_sparse_bwd_fused(
            meta["block_cols"], meta["nblocks"], meta["mask_slot"],
            meta["is_partial"], meta["pmask"], q, k, v, g, m, l, D,
            max_bpr=meta["max_bpr"], **kw)
    meta = spec.flash_bwd_meta(q.device)
    dq = flash_sparse_bwd_dq(
        meta["block_cols"], meta["nblocks"], meta["mask_slot"],
        meta["is_partial"], meta["pmask"], q, k, v, g, m, l, D,
        max_bpr=meta["max_bpr"], **kw)
    dk, dv = flash_sparse_bwd_dkv(
        meta["t_src_i"], meta["t_nblocks"], meta["t_mask_slot"],
        meta["t_is_partial"], meta["pmask"], q, k, v, g, m, l, D,
        max_bpc=meta["max_bpc"], **kw)
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, spec, q, k, v, scale, group):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, m, l = _fused_fwd(spec, q, k, v, scale, group)
        ctx.spec, ctx.scale, ctx.group = spec, scale, group
        ctx.save_for_backward(q, k, v, out, m, l)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, out, m, l = ctx.saved_tensors
        g = g.contiguous()
        D = (g * out).sum(-1)                                 # [R, s]
        dq, dk, dv = _fused_bwd(ctx.spec, q, k, v, g, m, l, D, ctx.scale,
                                ctx.group)
        return None, dq * ctx.scale, dk, dv, None, None


def fused_sparse_attention(spec: BatchedPanelSpec, q, k, v, scale=None,
                           group: int = 1):
    """``q: [R, s, hd]`` with ``R = spec.B * spec.heads`` -> ``[R, s, hd]``;
    softmax over the nonzeros of each replica's mask row. Differentiable in
    ``q``, ``k`` and ``v``.

    ``group`` (GQA): ``k``/``v`` carry ``R // group`` replicas; each run of
    ``group`` consecutive query replicas reads its shared KV replica
    (``r // group``, the head-minor ``b*heads + h`` fold order)."""
    if q.shape[0] != spec.R:
        raise ValueError(f"replica dim {q.shape[0]} != spec.R {spec.R}")
    if q.shape[1] != spec.m:
        raise ValueError(f"seq {q.shape[1]} != mask rows {spec.m}")
    if group < 1 or spec.R % group or spec.heads % group:
        raise ValueError(f"group {group} must divide heads {spec.heads}")
    if k.shape[0] != q.shape[0] // group or v.shape[0] != q.shape[0] // group:
        raise ValueError(
            f"k/v replicas {k.shape[0]}/{v.shape[0]} != R // group "
            f"{q.shape[0] // group}")
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    return _FusedAttention.apply(spec, q, k, v, float(scale), int(group))
