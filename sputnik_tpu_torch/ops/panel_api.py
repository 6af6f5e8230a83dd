"""Panel-native differentiable ops (counterpart of
``sputnik_tpu/ops/panel_api.py``).

The device layout of sparse values is the block panel
``f32[mb, max_bpr, bm, bk]`` (``blocking.BlockView``), and the ops close
over it:

  * ``spmm`` / ``spmm_bias`` / ``spmm_bias_relu``: panel x dense -> dense
    (the panel SpMM kernel and its epilogues)
  * ``spmm_t``: panel^T x dense -> dense (the transposed SpMM kernel, off
    the original panel through transposed block metadata)
  * ``sddmm``: dense x dense -> panel (the panel SDDMM kernel)
  * ``sparse_softmax``: panel -> panel (B5's panel rows, forward and
    backward one launch each)

``PanelSpec(..., compressed=True)`` selects the true-BSR layout
(``blocking.CompressedView``): panels ``f32[num_blocks + 1, bm, bk]``, only
the occupied tiles, back to back. The same ops and Functions run on it
through the compressed kernels (SpMM B13a, SpMM^T B13b, SDDMM B14), and
``sparse_softmax`` through the two compressed softmax kernels (row
statistics B15a, normalise B15b; its backward on their second modes); the
dump tile ``num_blocks`` is exactly 0 in every output and gradient.

Each op is a ``torch.autograd.Function`` whose backward is the JAX
package's ``custom_vjp`` algebra on the same kernels: SpMM <- SDDMM +
SpMM^T, SDDMM <- SpMM + SpMM^T, softmax <- ``p * (g - rowsum(p * g))``.
Panel gradients are exactly 0 at masked and padded slots, so an optimizer
never moves a pruned weight. Every op also takes a leading replica
dimension, ``R`` panels over the one topology (``[R, mb, max_bpr, bm, bk]``
with dense operands ``[R, n, q]``): that is how ``SparseAttention`` runs its
``b*heads`` replicas in one launch. CSR <-> panel conversion happens once at
the boundary. Tiles are Hopper's own (64 x 64 by default); outputs, never
panel bytes, are comparable with the JAX package's.

Dtypes follow JAX's ``_match_dtypes``: a mixed pair (a bf16 panel with an
f32 dense operand, or the reverse) promotes as ``torch.promote_types``
does, and the result takes the promoted dtype (``sparse_softmax`` the
panel's). The ops compute in float32, the kernels' type (float64 stays
float64, for the plain versions on the CPU): each operand is cast at the
op's boundary, and the autograd of that cast hands every gradient back in
its primal's dtype, as JAX's custom_vjps cast their cotangents.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable

from ..blocking import build_compressed
from .kernels import bsr_compressed as _c
from .kernels import ell_softmax as _sm
from .kernels.bsr_sddmm import bsr_sddmm_panel
from .kernels.bsr_spmm import bsr_spmm_panel
from .kernels.bsr_spmm_t import bsr_spmm_t_panel

__all__ = [
    "PanelSpec",
    "DEFAULT_BLOCK",
    "values_to_panel",
    "values_to_panel_np",
    "panel_to_values",
    "panel_to_values_np",
    "panel_kaiming_values",
    "spmm",
    "spmm_bias",
    "spmm_bias_relu",
    "spmm_t",
    "sddmm",
    "sparse_softmax",
]

# One 64 x 64 tile per 256-thread CUDA block (csrc/common.cuh). Not a
# measured optimum: the first tile that is right on the card.
DEFAULT_BLOCK = (64, 64)

_NEG_LARGE = -1e30


def _view(topo, bm: int, bk: int, compressed: bool = False):
    """The ELL ``BlockView`` or, with ``compressed``, the ``CompressedView``
    of ``topo`` at ``(bm, bk)``. The compressed view is built once per
    topology and tile and kept in the topology's block cache beside the
    block view it derives from (nothing is set on the frozen view)."""
    if not compressed:
        return topo.block(bm, bk)
    key = ("compressed", bm, bk)
    view = topo._block_cache.get(key)
    if view is None:
        view = topo._block_cache[key] = build_compressed(topo, bm=bm, bk=bk)
    return view


def values_to_panel_np(topo, values: np.ndarray, bm: int, bk: int,
                       *, compressed: bool = False):
    """Host-side CSR values -> panel (module init / weight import), ELL or,
    with ``compressed``, true-BSR. Dtype-preserving."""
    bv = _view(topo, bm, bk, compressed)
    values = np.asarray(values)
    flat = np.zeros(bv.dump + 1, dtype=values.dtype)
    flat[bv.scatter_idx] = values
    return flat[: bv.dump].reshape(bv.values_shape)


def panel_to_values_np(topo, panel: np.ndarray, bm: int, bk: int,
                       *, compressed: bool = False):
    """Host-side panel -> CSR values (export). Dtype-preserving."""
    bv = _view(topo, bm, bk, compressed)
    panel = np.asarray(panel)
    flat = np.concatenate([panel.reshape(-1), np.zeros(1, panel.dtype)])
    return flat[np.minimum(bv.gather_idx, bv.dump)]


def values_to_panel(topo, values: torch.Tensor, bm: int, bk: int,
                    *, compressed: bool = False):
    """Tensor CSR values -> panel (boundary op, not for per-step use)."""
    bv = _view(topo, bm, bk, compressed)
    idx = torch.as_tensor(bv.scatter_idx, dtype=torch.int64,
                          device=values.device)
    flat = values.new_zeros(bv.dump + 1).index_copy(0, idx, values)
    return flat[: bv.dump].reshape(bv.values_shape)


def panel_to_values(topo, panel: torch.Tensor, bm: int, bk: int,
                    *, compressed: bool = False):
    bv = _view(topo, bm, bk, compressed)
    idx = torch.as_tensor(np.minimum(bv.gather_idx, bv.dump),
                          dtype=torch.int64, device=panel.device)
    flat = torch.cat([panel.reshape(-1), panel.new_zeros(1)])
    return flat.index_select(0, idx)


def panel_kaiming_values(topo, bm: int, bk: int, *, gain: float = 1.0,
                         generator: Optional[torch.Generator] = None,
                         dtype=torch.float32,
                         compressed: bool = False) -> torch.Tensor:
    """Kaiming-uniform init over the nonzero slots, in panel layout (ELL or,
    with ``compressed``, true-BSR; zeros elsewhere), on the CPU; move it
    with ``.to(device)``."""
    bv = _view(topo, bm, bk, compressed)
    fan_in = max(float(topo.nnz) / max(topo.m, 1), 1.0)
    bound = gain * float(np.sqrt(3.0 / fan_in))
    vals = torch.empty(bv.values_shape, dtype=dtype)
    vals.uniform_(-bound, bound, generator=generator)
    return vals * torch.as_tensor(bv.mask, dtype=dtype)


class PanelSpec:
    """Static ``(topology, bm, bk[, bn], compressed)`` bundle for panel ops;
    equal (and hashed alike) for the same topology object and fields.

    Holds the block metadata as device tensors, built once per device
    (``spec.meta(device)``; the flat API's index maps in
    ``spec.flat_meta(device)``). ``bn``, JAX's slot, overrides the width
    rule of the int8 ops' activation tiles (``int8_api``); no other op
    reads it. ``compressed=True`` selects the true-BSR layout
    (``blocking.CompressedView``): panels ``[num_blocks + 1, bm, bk]``."""

    __slots__ = ("topo", "bm", "bk", "bn", "compressed", "_view", "_meta")

    def __init__(self, topo, bm: Optional[int] = None,
                 bk: Optional[int] = None, bn: Optional[int] = None,
                 compressed: bool = False):
        self.topo = topo
        self.bm = bm or DEFAULT_BLOCK[0]
        self.bk = bk or DEFAULT_BLOCK[1]
        self.bn = bn
        self.compressed = bool(compressed)
        self._view = _view(topo, self.bm, self.bk, self.compressed)
        self._meta = {}

    @property
    def view(self):
        return self._view

    def meta(self, device) -> dict:
        """Block metadata on ``device``.

        ELL: ``block_cols`` i32[mb*max_bpr], ``nblocks`` i32[mb], the f32
        element ``mask`` [mb, max_bpr, bm, bk], and the transposed walk of
        ``BlockView.transpose_meta``: ``t_src_i`` / ``t_src_s``
        i32[kb*max_bpc] and ``t_nblocks`` i32[kb].

        Compressed: ``block_offsets`` i32[mb+1], ``block_cols`` and
        ``block_rows`` i32[num_blocks+1], the f32 ``mask`` [num_blocks+1,
        bm, bk], the transposed walk of ``CompressedView.transpose_meta``
        by global tile id: ``t_gblk`` / ``t_rows`` i32[kb*max_bpc] and
        ``t_nblocks`` i32[kb], and ``split_plans``, the split plans of the
        compressed SpMM and softmax (``kernels.bsr_compressed.SplitPlans``,
        one per chunk size, built from the host's ``block_offsets`` on
        first use, and B15a's merge counters)."""
        device = torch.device(device)
        got = self._meta.get(device)
        if got is None:
            bv = self._view
            t_nblocks, t_src = bv.transpose_meta()
            t_a, t_b = (np.ascontiguousarray(t_src[:, :, c]).reshape(-1)
                        for c in (0, 1))
            mask = torch.as_tensor(bv.mask, dtype=torch.float32,
                                   device=device)
            if self.compressed:
                got = dict(
                    block_offsets=torch.as_tensor(bv.block_offsets,
                                                  device=device),
                    block_cols=torch.as_tensor(bv.block_cols, device=device),
                    block_rows=torch.as_tensor(bv.block_rows, device=device),
                    mask=mask, t_gblk=torch.as_tensor(t_a, device=device),
                    t_rows=torch.as_tensor(t_b, device=device),
                    t_nblocks=torch.as_tensor(t_nblocks, device=device),
                    split_plans=_c.SplitPlans(bv.block_offsets, device))
            else:
                got = dict(
                    block_cols=torch.as_tensor(bv.block_cols.reshape(-1),
                                               device=device),
                    nblocks=torch.as_tensor(bv.nblocks, device=device),
                    mask=mask, t_src_i=torch.as_tensor(t_a, device=device),
                    t_src_s=torch.as_tensor(t_b, device=device),
                    t_nblocks=torch.as_tensor(t_nblocks, device=device))
            self._meta[device] = got
        return got

    def flat_meta(self, device) -> dict:
        """Index maps of the flat (CSR-ordered) API on ``device``: ``slot``
        int64[nnz] (each nonzero's offset in the flattened panel),
        ``row_offsets`` i32[m + 1] and ``row_ids`` int64[nnz_pad] (padding
        slots -> m). Built once per device, like :meth:`meta`."""
        device = torch.device(device)
        key = ("flat", device)
        got = self._meta.get(key)
        if got is None:
            t = self.topo
            got = dict(
                slot=torch.as_tensor(self._view.scatter_idx[: t.nnz],
                                     dtype=torch.int64, device=device),
                row_offsets=torch.as_tensor(t.row_offsets, device=device),
                row_ids=torch.as_tensor(t.row_ids, dtype=torch.int64,
                                        device=device))
            self._meta[key] = got
        return got

    def __hash__(self):
        return hash((id(self.topo), self.bm, self.bk, self.bn,
                     self.compressed))

    def __eq__(self, other):
        return (isinstance(other, PanelSpec) and self.topo is other.topo
                and (self.bm, self.bk, self.bn, self.compressed)
                == (other.bm, other.bk, other.bn, other.compressed))

    def __repr__(self):
        return (f"PanelSpec({self.topo!r}, bm={self.bm}, bk={self.bk}, "
                f"bn={self.bn}, compressed={self.compressed})")


def _spec(spec) -> PanelSpec:
    return spec if isinstance(spec, PanelSpec) else PanelSpec(spec)


def work_dtype(dtype) -> torch.dtype:
    """The dtype an op computes in for a promoted ``dtype``: float32, the
    kernels' type, or float64 (the plain versions on the CPU)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _promote(a, b):
    """``(a, b, out_dtype)``: the pair cast to the work dtype of their
    promoted dtype, which the op's result takes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    w = work_dtype(dt)
    return a.to(w), b.to(w), dt


def _check_rows(name, x, n_true, n_pad, rank):
    """A wrong-sized operand (forgotten transpose, wrong feature dim) would
    read zero rows and return plausible wrong numbers: reject it."""
    if x.dim() != rank:
        raise ValueError(f"{name} must be rank {rank}, got shape "
                         f"{tuple(x.shape)}")
    if x.shape[-2] not in (n_true, n_pad):
        raise ValueError(f"{name} has {x.shape[-2]} rows; expected {n_true} "
                         f"(or tile-padded {n_pad})")


def _replicated(spec, panel) -> bool:
    rank = 3 if spec.compressed else 4     # the layout's own panel rank
    if panel.dim() not in (rank, rank + 1):
        raise ValueError(f"panel must be rank {rank} (or {rank + 1} with "
                         f"replicas), got {tuple(panel.shape)}")
    return panel.dim() == rank + 1


# Raw launches on replicated operands (``[R, ...]``, contiguous), the kernel
# chosen by the spec's layout. They record no gradient: the Functions below
# call them in forward and backward.


def _raw_spmm(spec, panel, dense, bias=None, epilogue="none", rows=None):
    meta = spec.meta(panel.device)
    rows = spec.topo.m if rows is None else rows
    if spec.compressed:
        return _c.bsr_spmm_panel_c(meta["block_offsets"], meta["block_cols"],
                                   panel, dense.contiguous(), bias, rows=rows,
                                   epilogue=epilogue,
                                   plans=meta["split_plans"])
    return bsr_spmm_panel(meta["block_cols"], meta["nblocks"], panel,
                          dense.contiguous(), bias, rows=rows,
                          epilogue=epilogue)


def _raw_spmm_t(spec, panel, g, rows):
    meta = spec.meta(panel.device)
    if spec.compressed:
        return _c.bsr_spmm_t_panel_c(meta["t_gblk"], meta["t_rows"],
                                     meta["t_nblocks"], panel, g.contiguous(),
                                     rows=rows)
    return bsr_spmm_t_panel(meta["t_src_i"], meta["t_src_s"],
                            meta["t_nblocks"], panel, g.contiguous(),
                            rows=rows)


def _raw_sddmm(spec, lhs, rhs):
    meta = spec.meta(lhs.device)
    if spec.compressed:
        return _c.bsr_sddmm_panel_c(meta["block_rows"], meta["block_cols"],
                                    lhs.contiguous(), rhs.contiguous(),
                                    meta["mask"])
    return bsr_sddmm_panel(meta["block_cols"], meta["nblocks"],
                           lhs.contiguous(), rhs.contiguous(), meta["mask"])


class _SpMM(torch.autograd.Function):
    """``epilogue(A @ dense (+ bias))``; backward (JAX ``_spmm_bwd`` /
    ``_spmm_br_bwd``): ``ge = g`` (masked by ``out > 0`` under ReLU),
    d_panel = SDDMM(ge, dense), d_dense = SpMM^T(panel, ge),
    d_bias = the sum of ``ge`` over replicas and columns."""

    @staticmethod
    def forward(ctx, spec, panel, dense, bias, epilogue):
        out = _raw_spmm(spec, panel, dense, bias, epilogue)
        ctx.spec, ctx.epilogue = spec, epilogue
        ctx.save_for_backward(panel, dense,
                              out if epilogue == "bias_relu" else None)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        panel, dense, out = ctx.saved_tensors
        spec = ctx.spec
        if out is not None:
            g = torch.where(out > 0, g, 0.0)
        g = g.contiguous()
        need = ctx.needs_input_grad
        d_panel = _raw_sddmm(spec, g, dense) if need[1] else None
        d_dense = (_raw_spmm_t(spec, panel, g, dense.shape[1])
                   if need[2] else None)
        d_bias = g.sum(dim=(0, 2)) if need[3] else None
        return None, d_panel, d_dense, d_bias, None


class _SpMMT(torch.autograd.Function):
    """``A^T @ dense``; backward (JAX ``_spmm_t_bwd``): d_panel =
    SDDMM(dense, g), d_dense = SpMM(panel, g)."""

    @staticmethod
    def forward(ctx, spec, panel, dense):
        ctx.spec = spec
        ctx.save_for_backward(panel, dense)
        return _raw_spmm_t(spec, panel, dense, spec.topo.n)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        panel, dense = ctx.saved_tensors
        spec, g = ctx.spec, g.contiguous()
        need = ctx.needs_input_grad
        d_panel = _raw_sddmm(spec, dense, g) if need[1] else None
        d_dense = _raw_spmm(spec, panel, g) if need[2] else None
        if d_dense is not None and d_dense.shape[1] != dense.shape[1]:
            d_dense = F.pad(d_dense, (0, 0, 0, dense.shape[1] - spec.topo.m))
        return None, d_panel, d_dense


class _SDDMM(torch.autograd.Function):
    """Sampled ``lhs @ rhs^T``; backward (JAX ``_sddmm_bwd``) on the masked
    panel cotangent ``gp``: d_lhs = SpMM(gp, rhs), d_rhs = SpMM^T(gp, lhs)."""

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
        g = torch.where(spec.meta(g.device)["mask"] != 0, g, 0.0)
        need = ctx.needs_input_grad
        d_lhs = d_rhs = None
        if need[1]:
            d_lhs = _raw_spmm(spec, g, rhs)
            if d_lhs.shape[1] != lhs.shape[1]:
                d_lhs = F.pad(d_lhs, (0, 0, 0, lhs.shape[1] - spec.topo.m))
        if need[2]:
            d_rhs = _raw_spmm_t(spec, g, lhs, rhs.shape[1])
        return None, d_lhs, d_rhs


class _MaskedSoftmax(torch.autograd.Function):
    """Row softmax over the panel rows (axes max_bpr, bk) of ``panel [R, mb,
    max_bpr, bm, bk]`` where the spec's f32 ``mask [n_masks, ...]`` is set,
    replica ``r`` on mask ``r // heads`` (B5's panel forward mode); backward
    (JAX ``_softmax_bwd`` / ``_sm_bh_bwd``): ``p * (g - rowsum(p * g))``,
    B5's panel backward mode. One launch each."""

    @staticmethod
    def forward(ctx, panel, mask, nblocks, heads):
        p = _sm.panel_softmax_kernel(mask, nblocks, panel, heads=heads)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        dx = _sm.panel_softmax_bwd_kernel(p, g.contiguous())
        return dx, None, None, None


def masked_softmax(panel, mask, nblocks, heads: int):
    """The masked row softmax of ``sparse_softmax`` and
    ``batched_panel.sparse_softmax_bh``: ``panel [R, mb, max_bpr, bm, bk]``,
    the spec's f32 ``mask [n_masks, mb, max_bpr, bm, bk]`` and ``nblocks
    i32[n_masks, mb]`` (``R = n_masks * heads``)."""
    return _MaskedSoftmax.apply(panel.contiguous(), mask, nblocks, heads)


class _CompressedSoftmax(torch.autograd.Function):
    """Row softmax over the compressed panel ``[R, num_blocks + 1, bm, bk]``,
    whose rows are ragged across back-to-back tiles: the row statistics
    (B15a, a row-block's tiles walked in chunks and merged), then each tile
    normalised against its row-block's statistics (B15b). Backward (JAX
    ``_softmax_bwd``, compressed branch): ``p * (g - rowsum(p * g))`` in two
    launches, the ragged row sum by B15a's walk (``c_softmax_rowsum``; JAX
    takes it with the compressed SpMM against a ones column) and the
    product by B15b's pass (``c_softmax_grad``). The cotangent counts as 0
    at masked slots and at the dump tile (the output is 0 there whatever
    the input), so a NaN there cannot leak: the gradient is exactly 0 at
    every masked slot and at the dump tile. ``meta``: a compressed
    ``PanelSpec.meta(device)`` (or one shard's of the sharded layout)."""

    @staticmethod
    def forward(ctx, meta, panel):
        row_max, row_denom = _c.c_softmax_stats(
            meta["block_offsets"], panel, meta["mask"],
            plans=meta["split_plans"])
        p = _c.c_softmax_apply(meta["block_rows"], panel, meta["mask"],
                               row_max, row_denom)
        ctx.meta = meta
        ctx.save_for_backward(p)
        return p

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        meta = ctx.meta
        g = g.contiguous()
        rs = _c.c_softmax_rowsum(meta["block_offsets"], p, g, meta["mask"],
                                 plans=meta["split_plans"])
        return None, _c.c_softmax_grad(meta["block_rows"], p, g,
                                       meta["mask"], rs)


def compressed_softmax(meta, panel):
    """The masked row softmax of ``sparse_softmax`` on the compressed
    layout: ``panel [R, num_blocks + 1, bm, bk]`` and the layout's metadata
    on the panel's device (``block_offsets``, ``block_rows``, the f32
    ``mask`` and ``split_plans``, as ``PanelSpec.meta`` holds them)."""
    return _CompressedSoftmax.apply(meta, panel.contiguous())


def _rep(x, rep):
    return x if rep else x[None]


def _unrep(x, rep):
    return x if rep else x[0]


def _spmm(spec, panel, dense, bias, epilogue):
    spec = _spec(spec)
    t, bv = spec.topo, spec.view
    rep = _replicated(spec, panel)
    _check_rows("dense", dense, t.n, bv.n_pad, 3 if rep else 2)
    panel, dense, dt = _promote(panel, dense)
    if bias is not None:
        bias = bias.to(panel.dtype)
    out = _SpMM.apply(spec, _rep(panel, rep).contiguous(),
                      _rep(dense, rep).contiguous(), bias, epilogue)
    return _unrep(out, rep).to(dt)


def spmm(spec, panel, dense):
    """``A_panel @ dense``: ``[mb,max_bpr,bm,bk] x [n, q] -> [m, q]``, or
    with replicas ``[R, ...] x [R, n, q] -> [R, m, q]``."""
    return _spmm(spec, panel, dense, None, "none")


def spmm_bias(spec, panel, dense, bias):
    """Fused ``A_panel @ dense + bias[:, None]``."""
    return _spmm(spec, panel, dense, bias, "bias")


def spmm_bias_relu(spec, panel, dense, bias):
    """Fused ``relu(A_panel @ dense + bias[:, None])``."""
    return _spmm(spec, panel, dense, bias, "bias_relu")


def spmm_t(spec, panel, dense):
    """``A_panel^T @ dense``: ``[n, q]`` from ``dense [m, q]``, or with
    replicas ``[R, ...] x [R, m, q] -> [R, n, q]``; off the original panel
    (no transposed panel is built)."""
    spec = _spec(spec)
    t, bv = spec.topo, spec.view
    rep = _replicated(spec, panel)
    _check_rows("dense", dense, t.m, bv.m_pad, 3 if rep else 2)
    panel, dense, dt = _promote(panel, dense)
    out = _SpMMT.apply(spec, _rep(panel, rep).contiguous(),
                       _rep(dense, rep).contiguous())
    return _unrep(out, rep).to(dt)


def sddmm(spec, lhs, rhs):
    """Sampled ``lhs @ rhs^T`` -> panel values: ``[m, d] x [n, d]`` -> panel,
    or with replicas ``[R, m, d] x [R, n, d] -> [R, *panel]``."""
    spec = _spec(spec)
    t, bv = spec.topo, spec.view
    rank = lhs.dim()
    if rank not in (2, 3):
        raise ValueError(f"lhs must be rank 2 or 3, got {tuple(lhs.shape)}")
    _check_rows("lhs", lhs, t.m, bv.m_pad, rank)
    _check_rows("rhs", rhs, t.n, bv.n_pad, rank)
    rep = rank == 3
    lhs, rhs, dt = _promote(lhs, rhs)
    out = _SDDMM.apply(spec, _rep(lhs, rep).contiguous(),
                       _rep(rhs, rep).contiguous())
    return _unrep(out, rep).to(dt)


def sparse_softmax(spec, panel):
    """Row-wise softmax over the nonzeros, panel layout in and out (with or
    without a leading replica dimension); masked slots stay exactly 0 and a
    row without nonzeros gives 0."""
    spec = _spec(spec)
    rep = _replicated(spec, panel)
    dt = panel.dtype
    panel = panel.to(work_dtype(dt))
    if spec.compressed:
        return _unrep(compressed_softmax(spec.meta(panel.device),
                                         _rep(panel, rep)), rep).to(dt)
    meta = spec.meta(panel.device)
    x = _rep(panel, rep)
    p = masked_softmax(x, meta["mask"][None], meta["nblocks"][None],
                       x.shape[0])
    return _unrep(p, rep).to(dt)
