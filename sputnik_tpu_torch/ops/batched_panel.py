"""Batched panel ops for the many-mask family (counterpart of
``sputnik_tpu/ops/batched_panel.py``).

``BatchedPanelSpec`` bundles ``B`` same-shape topologies with ``heads``
replicas each (``R = B * heads``, replica ``r`` uses mask ``r // heads``)
and their block metadata stacked per mask. The ops close over it, with the
JAX package's ``custom_vjp`` algebra as ``torch.autograd.Function``s:

  * ``spmm_bh``: panels ``[R, *]`` x dense ``[R, n, q]`` -> ``[R, m, q]``
    (kernel B6); backward SDDMM (B7) + transposed SpMM (B8);
  * ``sddmm_bh``: ``[R, m, d]`` x ``[R, n, d]`` -> panels (B7); backward
    SpMM (B6) + transposed SpMM (B8) on the cotangent zeroed at masked and
    padded slots;
  * ``sparse_softmax_bh``: panels -> panels on B5's panel rows
    (``panel_api.masked_softmax``, shared with ``sparse_softmax``: the
    stacked mask, replica ``r`` on mask ``r // heads``); backward ``p * (g
    - rowsum(p * g))``, B5's backward mode.

The ``heads`` replicas of a mask share its metadata: nothing is copied per
head (the element mask broadcasts as ``[B, 1, ...]``). The spec also holds
the fused attention's flash metadata (``flash_meta``, ``flash_bwd_meta``).
Tiles are Hopper's own (64 x 64 by default); outputs, never panel bytes,
are comparable with the JAX package's.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from torch.autograd.function import once_differentiable

from ..blocking import stack_block_meta
from .kernels.batched_panel import (sddmm_bh_kernel, spmm_bh_kernel,
                                    spmm_t_bh_kernel)
from .kernels.flash_sparse import build_flash_bwd_meta, build_flash_meta
from .panel_api import masked_softmax, work_dtype

__all__ = ["BatchedPanelSpec", "spmm_bh", "sddmm_bh", "sparse_softmax_bh"]


class BatchedPanelSpec:
    """Static bundle for ``B`` same-shape topologies x ``heads`` replicas."""

    def __init__(self, topologies: List, *, heads: int = 1, bm: int = 64,
                 bk: int = 64):
        self.topologies = list(topologies)
        self.B = len(topologies)
        self.heads = heads
        self.bm, self.bk = bm, bk
        self.views = [t.block(bm, bk) for t in topologies]
        self.meta = stack_block_meta(self.views)
        self.mb, self.kb = self.meta["mb"], self.meta["kb"]
        self.max_bpr = self.meta["max_bpr"]
        self.max_bpc = self.meta["max_bpc"]
        self.m = topologies[0].m
        self.n = topologies[0].n
        self.m_pad = self.mb * bm
        self.n_pad = self.kb * bk
        self._meta_np = {"panel": self.meta}
        self._meta_dev = {}

    @classmethod
    def from_many_mask(cls, mt, *, heads: int = 1, bm: int = 64,
                       bk: int = 64) -> "BatchedPanelSpec":
        return cls(mt.topologies, heads=heads, bm=bm, bk=bk)

    @property
    def R(self) -> int:
        return self.B * self.heads

    @property
    def panel_shape(self):
        """Per-replica panel shape."""
        return (self.mb, self.max_bpr, self.bm, self.bk)

    def stack_values(self, values_r) -> np.ndarray:
        """Flat many-mask values ``[R, nnz_pad]`` -> panels ``[R, *]``
        (host-side boundary)."""
        values_r = np.asarray(values_r, np.float32)
        out = np.zeros((self.R,) + self.panel_shape, np.float32)
        for r in range(self.R):
            v = self.views[r // self.heads]
            flat = np.zeros(v.dump + 1, np.float32)
            take = min(v.scatter_idx.shape[0], values_r.shape[1])
            flat[v.scatter_idx[:take]] = values_r[r, :take]
            out[r, :, : v.max_bpr] = flat[: v.dump].reshape(v.values_shape)
        return out

    def unstack_values(self, panels: torch.Tensor,
                       nnz_pad: int) -> torch.Tensor:
        """Panels ``[R, *]`` -> flat many-mask values ``[R, nnz_pad]`` (a
        differentiable gather; boundary only)."""
        outs = []
        for r in range(self.R):
            v = self.views[r // self.heads]
            p = panels[r, :, : v.max_bpr]
            flat = torch.cat([p.reshape(-1), panels.new_zeros(1)])
            g = np.full(nnz_pad, v.dump, np.int64)
            take = min(nnz_pad, len(v.gather_idx))
            g[:take] = np.minimum(v.gather_idx[:take], v.dump)
            outs.append(flat[torch.as_tensor(g, device=panels.device)])
        return torch.stack(outs)

    def _device_meta(self, kind: str, build, device) -> dict:
        """``build(views)`` as tensors on ``device`` (ints stay ints): built
        on the host once, moved once per device."""
        if kind not in self._meta_np:
            self._meta_np[kind] = build(self.views)
        key = (kind, torch.device(device))
        got = self._meta_dev.get(key)
        if got is None:
            got = {k: (torch.as_tensor(v, device=key[1])
                       if isinstance(v, np.ndarray) else v)
                   for k, v in self._meta_np[kind].items()}
            self._meta_dev[key] = got
        return got

    def panel_meta(self, device) -> dict:
        """The stacked block metadata (``blocking.stack_block_meta``) on
        ``device``: ``block_cols`` i32[B, mb*max_bpr], ``nblocks``
        i32[B, mb], the f32 element ``mask`` [B, mb, max_bpr, bm, bk] and
        the transposed walk ``t_src_i`` / ``t_src_s`` i32[B, kb*max_bpc],
        ``t_nblocks`` i32[B, kb]."""
        return self._device_meta("panel", stack_block_meta, device)

    def mask_bh(self, device) -> torch.Tensor:
        """The element mask broadcast to replicas without ``heads`` copies:
        a bool ``[B, 1, mb, max_bpr, bm, bk]`` that broadcasts against
        panels viewed as ``[B, heads, ...]``."""
        return self.panel_meta(device)["mask"][:, None] != 0

    def flash_meta(self, device) -> dict:
        """``kernels.flash_sparse.build_flash_meta`` of this spec on
        ``device``."""
        return self._device_meta("fwd", build_flash_meta, device)

    def flash_bwd_meta(self, device) -> dict:
        """``kernels.flash_sparse.build_flash_bwd_meta`` of this spec on
        ``device`` (the two-kernel backward's transposed walk)."""
        return self._device_meta("bwd", build_flash_bwd_meta, device)


# Raw launches on contiguous operands; they record no gradient: the
# Functions below call them in forward and backward.


def _raw_spmm(spec, panels, dense, rows):
    meta = spec.panel_meta(panels.device)
    return spmm_bh_kernel(meta["block_cols"], meta["nblocks"], panels,
                          dense.contiguous(), heads=spec.heads, rows=rows)


def _raw_spmm_t(spec, panels, g, rows):
    meta = spec.panel_meta(panels.device)
    return spmm_t_bh_kernel(meta["t_src_i"], meta["t_src_s"],
                            meta["t_nblocks"], panels, g.contiguous(),
                            heads=spec.heads, rows=rows)


def _raw_sddmm(spec, lhs, rhs):
    meta = spec.panel_meta(lhs.device)
    return sddmm_bh_kernel(meta["block_cols"], meta["nblocks"],
                           lhs.contiguous(), rhs.contiguous(), meta["mask"],
                           heads=spec.heads)


def _by_mask(spec, panels):
    """``[R, *panel]`` viewed as ``[B, heads, *panel]``."""
    return panels.reshape((spec.B, spec.heads) + panels.shape[1:])


class _SpMMBH(torch.autograd.Function):
    """``A_r @ dense_r``; backward (JAX ``_spmm_bh_bwd``): d_panels =
    SDDMM(g, dense), d_dense = SpMM^T(panels, g)."""

    @staticmethod
    def forward(ctx, spec, panels, dense):
        ctx.spec = spec
        ctx.save_for_backward(panels, dense)
        return _raw_spmm(spec, panels, dense, spec.m)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        panels, dense = ctx.saved_tensors
        spec, g = ctx.spec, g.contiguous()
        need = ctx.needs_input_grad
        d_panels = _raw_sddmm(spec, g, dense) if need[1] else None
        d_dense = (_raw_spmm_t(spec, panels, g, dense.shape[1])
                   if need[2] else None)
        return None, d_panels, d_dense


class _SDDMMBH(torch.autograd.Function):
    """Sampled ``lhs_r @ rhs_r^T``; backward (JAX ``_sddmm_bh_bwd``) on the
    cotangent zeroed at masked and padded slots: d_lhs = SpMM(gp, rhs),
    d_rhs = SpMM^T(gp, lhs)."""

    @staticmethod
    def forward(ctx, spec, lhs, rhs):
        ctx.spec = spec
        ctx.save_for_backward(lhs, rhs)
        return _raw_sddmm(spec, lhs, rhs)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        lhs, rhs = ctx.saved_tensors
        spec = ctx.spec
        # the output is 0 at masked and padded slots whatever the inputs:
        # a cotangent there carries no gradient
        g = torch.where(spec.mask_bh(g.device), _by_mask(spec, g), 0.0)
        g = g.reshape((spec.R,) + spec.panel_shape)
        need = ctx.needs_input_grad
        d_lhs = _raw_spmm(spec, g, rhs, lhs.shape[1]) if need[1] else None
        d_rhs = _raw_spmm_t(spec, g, lhs, rhs.shape[1]) if need[2] else None
        return None, d_lhs, d_rhs


def _check(spec, name, x, rows, rank=3):
    """A wrong-sized operand (forgotten transpose, wrong feature dim) would
    read zero rows and return plausible wrong numbers: reject it."""
    if x.dim() != rank or x.shape[0] != spec.R:
        raise ValueError(f"{name} must be [R={spec.R}, ...] of rank {rank}, "
                         f"got {tuple(x.shape)}")
    if rows is not None and x.shape[1] not in rows:
        raise ValueError(f"{name} has {x.shape[1]} rows; expected one of "
                         f"{sorted(set(rows))}")


def _check_panels(spec, panels):
    if tuple(panels.shape) != (spec.R,) + spec.panel_shape:
        raise ValueError(f"panels must be {(spec.R,) + spec.panel_shape}, "
                         f"got {tuple(panels.shape)}")


def spmm_bh(spec: BatchedPanelSpec, panels, dense):
    """Batched panel SpMM: ``[R, *panel] x [R, n, q] -> [R, m, q]``."""
    _check_panels(spec, panels)
    _check(spec, "dense", dense, (spec.n, spec.n_pad))
    return _SpMMBH.apply(spec, panels.contiguous(), dense.contiguous())


def sddmm_bh(spec: BatchedPanelSpec, lhs, rhs):
    """Batched sampled product: ``[R, m, d] x [R, n, d] -> [R, *panel]``;
    masked elements and padded slots are exactly 0."""
    _check(spec, "lhs", lhs, (spec.m, spec.m_pad))
    _check(spec, "rhs", rhs, (spec.n, spec.n_pad))
    if lhs.shape[2] != rhs.shape[2]:
        raise ValueError(f"lhs {tuple(lhs.shape)} and rhs {tuple(rhs.shape)} "
                         f"differ in their last dim")
    return _SDDMMBH.apply(spec, lhs.contiguous(), rhs.contiguous())


def sparse_softmax_bh(spec: BatchedPanelSpec, panels):
    """Batched row softmax over each replica's mask, panels in and out; a
    row without nonzeros gives 0 (no NaN)."""
    _check_panels(spec, panels)
    meta = spec.panel_meta(panels.device)
    dt = panels.dtype
    p = masked_softmax(panels.to(work_dtype(dt)), meta["mask"],
                       meta["nblocks"], spec.heads)
    return p.to(dt)
