"""Sparse softmax (B5): the CUDA kernel's four wrappers and their plain
PyTorch versions.

Replaces ``sputnik_tpu/ops/pallas/ell_softmax.py:ell_softmax_panel`` and
the row-wise VJP that JAX takes in XLA; the kernel is
``csrc/ell_softmax.cu``, one body with two address policies and two modes:

  * CSR rows (the flat API, ``values [R, nnz_pad]`` through
    ``row_offsets``): :func:`ell_softmax_kernel` forward,
    :func:`ell_softmax_bwd_kernel` backward; plain versions
    ``plain_ops.sparse_softmax`` / ``plain_ops.softmax_vjp``;
  * panel rows (``panel_api.sparse_softmax`` on an ELL spec and
    ``batched_panel.sparse_softmax_bh``, a panel ``[R, mb, max_bpr, bm,
    bk]`` with the spec's f32 mask ``[n_masks, ...]``, replica ``r`` on
    mask ``r // heads``): :func:`panel_softmax_kernel` forward,
    :func:`panel_softmax_bwd_kernel` backward; plain versions
    :func:`masked_softmax_plain` / :func:`masked_softmax_vjp_plain`.

Forward: the row max is clamped at -1e30 and the denominator at ``tiny``,
so a row with no live slot, or with only ``-inf`` scores, gives zeros;
masked slots and the CSR padding slots ``nnz..nnz_pad`` are 0. Backward:
``p * (g - rowsum(p * g))`` over every slot of the row (JAX's
``_sparse_softmax_bwd`` / ``_softmax_bwd`` / ``_sm_bh_bwd``), so a NaN
cotangent at a masked slot reaches its row as in JAX.

:func:`ell_softmax_panel` is the TPU kernel's own contract (an ``[m_pad,
l_pad]`` ELL panel and its mask) in plain PyTorch.
"""

from __future__ import annotations

import torch

from .. import plain_ops
from . import check_operands, guard_no_grad
from ._build import check, library

__all__ = ["ell_softmax_kernel", "ell_softmax_bwd_kernel",
           "panel_softmax_kernel", "panel_softmax_bwd_kernel",
           "masked_softmax_plain", "masked_softmax_vjp_plain",
           "ell_softmax_panel"]

_NEG_LARGE = -1e30

# (lanes a row, chunks a lane in registers) for every launch; (0, 0) is the
# kernel's own rule (``lanes_for`` in ``csrc/ell_softmax.cu``). A hook for
# measurements and tests, which set it and put it back: the sweep that
# chose the rule (``chip_smoke.py`` phase 2f) and the CUDA tests of every
# team size. Nothing in the package sets it.
_TEAM = (0, 0)


def ell_softmax_panel(panel, mask):
    """Masked row softmax on an ELL panel ``[m_pad, l_pad]`` where ``mask``
    (same shape) is nonzero: the TPU kernel's function, in plain PyTorch."""
    return masked_softmax_plain(panel[None, :, None, None],
                                mask[None, :, None, None], 1)[0, :, 0, 0]


def masked_softmax_plain(panel, mask, heads: int):
    """The panel policy's forward: the row softmax over the axes (max_bpr,
    bk) of ``panel [R, mb, max_bpr, bm, bk]`` where ``mask [n_masks, mb,
    max_bpr, bm, bk]`` (``R = n_masks * heads``) is nonzero."""
    n = mask.shape[0]
    live = (mask != 0)[:, None]
    x = panel.reshape(n, heads, *panel.shape[1:])
    v = torch.where(live, x, _NEG_LARGE)
    row_max = v.amax(dim=(-3, -1), keepdim=True).clamp(min=_NEG_LARGE)
    e = torch.where(live, torch.exp(v - row_max), 0.0)
    denom = e.sum(dim=(-3, -1), keepdim=True)
    p = e / denom.clamp(min=torch.finfo(panel.dtype).tiny)
    return p.reshape(panel.shape)


def masked_softmax_vjp_plain(p, g):
    """The panel policy's backward: ``p * (g - rowsum(p * g))`` over the
    axes (max_bpr, bk) of ``[R, mb, max_bpr, bm, bk]``, every slot."""
    return p * (g - (p * g).sum(dim=(-3, -1), keepdim=True))


def _aligned(t):
    """``t`` itself where its data is 16-byte aligned, else a copy (the
    kernel's 16-byte loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _csr_args(row_offsets, values, nnz):
    if values.dim() != 2 or row_offsets.dim() != 1:
        raise ValueError(f"values must be rank 2 and row_offsets rank 1, got "
                         f"{tuple(values.shape)} and "
                         f"{tuple(row_offsets.shape)}")
    if not 0 <= nnz <= values.shape[1]:
        raise ValueError(f"nnz {nnz} outside [0, {values.shape[1]}]")
    return values.shape[0], values.shape[1], row_offsets.numel() - 1


def _csr_launch(fn, name, row_offsets, a, b, nnz, bwd):
    R, nnz_pad, m = _csr_args(row_offsets, a, nnz)
    dev = a.device
    ops = dict(row_offsets=(row_offsets, torch.int32),
               values=(a, torch.float32))
    if b is not None:
        if b.shape != a.shape:
            raise ValueError(f"{name}: g {tuple(b.shape)} != p "
                             f"{tuple(a.shape)}")
        ops["g"] = (b, torch.float32)
    check_operands(name, dev, **ops)
    a = _aligned(a)
    b = _aligned(b) if b is not None else None
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    err = library().softmax_csr_f32(
        row_offsets.data_ptr(), a.data_ptr(),
        b.data_ptr() if b is not None else None, out.data_ptr(), R, m, nnz,
        nnz_pad, int(bwd), *_TEAM,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, name)
    fn.launches += 1
    return out


def ell_softmax_kernel(row_offsets, row_ids, values, *, nnz: int):
    """Row softmax over each CSR row, for every replica: ``row_offsets
    i32[m + 1]`` (``row_offsets[m] == nnz``), ``values f32[R, nnz_pad]`` ->
    ``f32[R, nnz_pad]``, 0 at ``nnz..nnz_pad``. ``row_ids int64[nnz_pad]``
    (padding slots -> ``m``, as ``PanelSpec.flat_meta`` holds them) are the
    plain version's segments; the kernel walks ``row_offsets``."""
    R, nnz_pad, m = _csr_args(row_offsets, values, nnz)
    if not values.is_cuda:
        return plain_ops.sparse_softmax(values, row_ids, row_ids < m, m)
    guard_no_grad("ell_softmax", "ops.api.sparse_softmax", values)
    return _csr_launch(ell_softmax_kernel, "ell_softmax", row_offsets,
                       values, None, nnz, False)


def ell_softmax_bwd_kernel(row_offsets, row_ids, p, g, *, nnz: int):
    """The CSR softmax's VJP, ``p * (g - rowsum(p * g))`` over each CSR row
    (the padding slots ``nnz..nnz_pad`` as one more row, as the plain
    version's segment ``m``): ``p, g f32[R, nnz_pad]`` -> ``f32[R,
    nnz_pad]``."""
    R, nnz_pad, m = _csr_args(row_offsets, p, nnz)
    if not p.is_cuda:
        return plain_ops.softmax_vjp(p, g, row_ids, m)
    guard_no_grad("ell_softmax_bwd", "ops.api.sparse_softmax", p, g)
    return _csr_launch(ell_softmax_bwd_kernel, "ell_softmax_bwd",
                       row_offsets, p, g, nnz, True)


def _panel_shape(name, panel, mask, heads):
    if panel.dim() != 5:
        raise ValueError(f"{name}: panel must be [R, mb, max_bpr, bm, bk], "
                         f"got {tuple(panel.shape)}")
    if mask is not None and (mask.dim() != 5
                             or mask.shape[1:] != panel.shape[1:]
                             or mask.shape[0] * heads != panel.shape[0]):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} must be "
                         f"[n_masks, *{tuple(panel.shape[1:])}] with n_masks "
                         f"* heads ({heads}) == R ({panel.shape[0]})")


def _panel_launch(fn, name, mask, nblocks, a, b, heads):
    R, mb, max_bpr, bm, bk = a.shape
    dev = a.device
    ops = dict(panel=(a, torch.float32))
    if b is not None:
        if b.shape != a.shape:
            raise ValueError(f"{name}: g {tuple(b.shape)} != p "
                             f"{tuple(a.shape)}")
        ops["g"] = (b, torch.float32)
    if mask is not None:
        if tuple(nblocks.shape) != (mask.shape[0], mb):
            raise ValueError(f"{name}: nblocks {tuple(nblocks.shape)} != "
                             f"{(mask.shape[0], mb)}")
        ops.update(mask=(mask, torch.float32), nblocks=(nblocks, torch.int32))
    check_operands(name, dev, **ops)
    a = _aligned(a)
    b = _aligned(b) if b is not None else None
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    vec = 4 if bk % 4 == 0 and (mask is None
                                or mask.data_ptr() % 16 == 0) else 1
    err = library().softmax_panel_f32(
        mask.data_ptr() if mask is not None else None,
        nblocks.data_ptr() if mask is not None else None, a.data_ptr(),
        b.data_ptr() if b is not None else None, out.data_ptr(), R, heads,
        mb, max_bpr, bm, bk, vec, int(b is not None), *_TEAM,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, name)
    fn.launches += 1
    return out


def panel_softmax_kernel(mask, nblocks, panel, *, heads: int):
    """Row softmax over the live slots of each panel row: ``panel f32[R, mb,
    max_bpr, bm, bk]``, the spec's ``mask f32[n_masks, mb, max_bpr, bm,
    bk]`` and ``nblocks i32[n_masks, mb]`` (``R = n_masks * heads``,
    replica ``r`` on mask ``r // heads``) -> ``f32[R, mb, max_bpr, bm,
    bk]``, exactly 0 at masked slots. The kernel reads no tile past a row
    block's ``nblocks``."""
    _panel_shape("panel_softmax", panel, mask, heads)
    if not panel.is_cuda:
        return masked_softmax_plain(panel, mask, heads)
    guard_no_grad("panel_softmax", "ops.panel_api.sparse_softmax", panel)
    return _panel_launch(panel_softmax_kernel, "panel_softmax", mask,
                         nblocks, panel, None, heads)


def panel_softmax_bwd_kernel(p, g):
    """The panel softmax's VJP, ``p * (g - rowsum(p * g))`` over every slot
    of each panel row: ``p, g f32[R, mb, max_bpr, bm, bk]`` -> the same."""
    _panel_shape("panel_softmax_bwd", p, None, 1)
    if not p.is_cuda:
        return masked_softmax_vjp_plain(p, g)
    guard_no_grad("panel_softmax_bwd", "ops.panel_api.sparse_softmax", p, g)
    return _panel_launch(panel_softmax_bwd_kernel, "panel_softmax_bwd", None,
                         None, p, g, 1)


ell_softmax_kernel.launches = 0
ell_softmax_bwd_kernel.launches = 0
panel_softmax_kernel.launches = 0
panel_softmax_bwd_kernel.launches = 0
