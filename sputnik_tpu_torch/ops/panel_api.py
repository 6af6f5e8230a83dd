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
  * ``sparse_softmax``: panel -> panel (plain PyTorch, as in JAX)

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
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable

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


def values_to_panel_np(topo, values: np.ndarray, bm: int, bk: int):
    """Host-side CSR values -> panel (module init / weight import).
    Dtype-preserving."""
    bv = topo.block(bm, bk)
    values = np.asarray(values)
    flat = np.zeros(bv.dump + 1, dtype=values.dtype)
    flat[bv.scatter_idx] = values
    return flat[: bv.dump].reshape(bv.values_shape)


def panel_to_values_np(topo, panel: np.ndarray, bm: int, bk: int):
    """Host-side panel -> CSR values (export). Dtype-preserving."""
    bv = topo.block(bm, bk)
    panel = np.asarray(panel)
    flat = np.concatenate([panel.reshape(-1), np.zeros(1, panel.dtype)])
    return flat[np.minimum(bv.gather_idx, bv.dump)]


def values_to_panel(topo, values: torch.Tensor, bm: int, bk: int):
    """Tensor CSR values -> panel (boundary op, not for per-step use)."""
    bv = topo.block(bm, bk)
    idx = torch.as_tensor(bv.scatter_idx, dtype=torch.int64,
                          device=values.device)
    flat = values.new_zeros(bv.dump + 1).index_copy(0, idx, values)
    return flat[: bv.dump].reshape(bv.values_shape)


def panel_to_values(topo, panel: torch.Tensor, bm: int, bk: int):
    bv = topo.block(bm, bk)
    idx = torch.as_tensor(np.minimum(bv.gather_idx, bv.dump),
                          dtype=torch.int64, device=panel.device)
    flat = torch.cat([panel.reshape(-1), panel.new_zeros(1)])
    return flat.index_select(0, idx)


def panel_kaiming_values(topo, bm: int, bk: int, *, gain: float = 1.0,
                         generator: Optional[torch.Generator] = None,
                         dtype=torch.float32) -> torch.Tensor:
    """Kaiming-uniform init over the nonzero slots, in panel layout (zeros
    elsewhere), on the CPU; move it with ``.to(device)``."""
    bv = topo.block(bm, bk)
    fan_in = max(float(topo.nnz) / max(topo.m, 1), 1.0)
    bound = gain * float(np.sqrt(3.0 / fan_in))
    vals = torch.empty(bv.values_shape, dtype=dtype)
    vals.uniform_(-bound, bound, generator=generator)
    return vals * torch.as_tensor(bv.mask, dtype=dtype)


class PanelSpec:
    """Static ``(topology, bm, bk[, bn])`` bundle for panel ops.

    Holds the block metadata as device tensors, built once per device
    (``spec.meta(device)``; the flat API's index maps in
    ``spec.flat_meta(device)``). ``bn``, JAX's slot, overrides the width
    rule of the int8 ops' activation tiles (``int8_api``); no other op
    reads it."""

    __slots__ = ("topo", "bm", "bk", "bn", "_view", "_meta")

    def __init__(self, topo, bm: Optional[int] = None,
                 bk: Optional[int] = None, bn: Optional[int] = None):
        self.topo = topo
        self.bm = bm or DEFAULT_BLOCK[0]
        self.bk = bk or DEFAULT_BLOCK[1]
        self.bn = bn
        self._view = topo.block(self.bm, self.bk)
        self._meta = {}

    @property
    def view(self):
        return self._view

    def meta(self, device) -> dict:
        """Block metadata on ``device``: ``block_cols`` i32[mb*max_bpr],
        ``nblocks`` i32[mb], the f32 element ``mask`` [mb, max_bpr, bm, bk],
        and the transposed walk of ``BlockView.transpose_meta``: ``t_src_i``
        / ``t_src_s`` i32[kb*max_bpc] and ``t_nblocks`` i32[kb]."""
        device = torch.device(device)
        got = self._meta.get(device)
        if got is None:
            bv = self._view
            t_nblocks, t_src = bv.transpose_meta()
            got = dict(
                block_cols=torch.as_tensor(bv.block_cols.reshape(-1),
                                           device=device),
                nblocks=torch.as_tensor(bv.nblocks, device=device),
                mask=torch.as_tensor(bv.mask, dtype=torch.float32,
                                     device=device),
                t_src_i=torch.as_tensor(
                    np.ascontiguousarray(t_src[:, :, 0]).reshape(-1),
                    device=device),
                t_src_s=torch.as_tensor(
                    np.ascontiguousarray(t_src[:, :, 1]).reshape(-1),
                    device=device),
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

    def __repr__(self):
        return (f"PanelSpec({self.topo!r}, bm={self.bm}, bk={self.bk}, "
                f"bn={self.bn})")


def _spec(spec) -> PanelSpec:
    return spec if isinstance(spec, PanelSpec) else PanelSpec(spec)


def _check_rows(name, x, n_true, n_pad, rank):
    """A wrong-sized operand (forgotten transpose, wrong feature dim) would
    read zero rows and return plausible wrong numbers: reject it."""
    if x.dim() != rank:
        raise ValueError(f"{name} must be rank {rank}, got shape "
                         f"{tuple(x.shape)}")
    if x.shape[-2] not in (n_true, n_pad):
        raise ValueError(f"{name} has {x.shape[-2]} rows; expected {n_true} "
                         f"(or tile-padded {n_pad})")


def _replicated(panel) -> bool:
    if panel.dim() not in (4, 5):
        raise ValueError(f"panel must be rank 4 (or 5 with replicas), got "
                         f"{tuple(panel.shape)}")
    return panel.dim() == 5


# Raw launches on replicated operands (``[R, ...]``, contiguous). They
# record no gradient: the Functions below call them in forward and backward.


def _raw_spmm(spec, panel, dense, bias=None, epilogue="none"):
    meta = spec.meta(panel.device)
    return bsr_spmm_panel(meta["block_cols"], meta["nblocks"], panel,
                          dense.contiguous(), bias, rows=spec.topo.m,
                          epilogue=epilogue)


def _raw_spmm_t(spec, panel, g, rows):
    meta = spec.meta(panel.device)
    return bsr_spmm_t_panel(meta["t_src_i"], meta["t_src_s"],
                            meta["t_nblocks"], panel, g.contiguous(),
                            rows=rows)


def _raw_sddmm(spec, lhs, rhs):
    meta = spec.meta(lhs.device)
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
    """Row softmax over the panel's row axes (-3, -1) where the bool
    ``mask`` (broadcast against the panel) is set; backward (JAX
    ``_softmax_bwd`` / ``_sm_bh_bwd``): ``p * (g - rowsum(p * g))``."""

    @staticmethod
    def forward(ctx, panel, mask):
        v = torch.where(mask, panel, _NEG_LARGE)
        row_max = v.amax(dim=(-3, -1), keepdim=True).clamp(min=_NEG_LARGE)
        e = torch.where(mask, torch.exp(v - row_max), 0.0)
        denom = e.sum(dim=(-3, -1), keepdim=True)
        p = e / denom.clamp(min=torch.finfo(panel.dtype).tiny)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return p * (g - (p * g).sum(dim=(-3, -1), keepdim=True)), None


def masked_softmax(panel, mask):
    """The masked row softmax of ``sparse_softmax`` and
    ``batched_panel.sparse_softmax_bh``, over a bool ``mask`` that
    broadcasts against ``panel``."""
    return _MaskedSoftmax.apply(panel, mask)


def _rep(x, rep):
    return x if rep else x[None]


def _unrep(x, rep):
    return x if rep else x[0]


def _spmm(spec, panel, dense, bias, epilogue):
    spec = _spec(spec)
    t, bv = spec.topo, spec.view
    rep = _replicated(panel)
    _check_rows("dense", dense, t.n, bv.n_pad, 3 if rep else 2)
    out = _SpMM.apply(spec, _rep(panel, rep).contiguous(),
                      _rep(dense, rep).contiguous(), bias, epilogue)
    return _unrep(out, rep)


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
    rep = _replicated(panel)
    _check_rows("dense", dense, t.m, bv.m_pad, 3 if rep else 2)
    out = _SpMMT.apply(spec, _rep(panel, rep).contiguous(),
                       _rep(dense, rep).contiguous())
    return _unrep(out, rep)


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
    out = _SDDMM.apply(spec, _rep(lhs, rep).contiguous(),
                       _rep(rhs, rep).contiguous())
    return _unrep(out, rep)


def sparse_softmax(spec, panel):
    """Row-wise softmax over the nonzeros, panel layout in and out (with or
    without a leading replica dimension); masked slots stay exactly 0 and a
    row without nonzeros gives 0."""
    spec = _spec(spec)
    _replicated(panel)
    return masked_softmax(panel, spec.meta(panel.device)["mask"] != 0)
