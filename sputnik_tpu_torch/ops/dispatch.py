"""The flat op set's kernel route (counterpart of
``sputnik_tpu/ops/pallas/dispatch.py`` and ``ops/pallas/__init__.py``).

The flat API keeps the reference's calling convention: CSR-ordered
``values [nnz_pad]`` (or ``[r, nnz_pad]``) beside a ``SparseTopology``.
This module runs it on the kernels:

  * ``spmm`` / ``spmm_bias_relu``: values -> block panel (a zero fill and
    a scatter of the nonzeros), then ``panel_api``'s SpMM (B1 and its
    epilogue) at the port's default tiles;
  * ``sddmm``: ``panel_api``'s SDDMM (B4), then panel -> values (a gather
    of the nonzeros);
  * ``sparse_softmax``: B5 on the CSR rows.

The values <-> panel maps are differentiable index ops, so the gradients
are ``panel_api``'s own: the SpMM's backward launches B4 (values) and B3
(dense operand), the SDDMM's B1 and B3, with no transposed panel. The
softmax is one autograd Function on B5's CSR rows: its forward mode, and
its backward mode ``p * (g - rowsum(p * g))`` (JAX's XLA VJP), one launch
each.

The index maps are device tensors, built once per device
(``PanelSpec.flat_meta``), and the ``PanelSpec`` once per topology. The
JAX dispatch's other pieces are TPU costs and stay there: its
identity-keyed values -> panel cache (the scatter cost ~12 ms on a TPU; on
the card see ``PERF.md``), bf16 operand streaming, the cache of jitted
closures and the 128 x 128 size floor.

Operands compute in float32, the kernels' type (float64 stays float64, for
the plain versions on the CPU); results take the promoted input dtype
(``panel_api``'s promotion; the softmax casts here).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import panel_api as P
from .kernels.ell_softmax import ell_softmax_bwd_kernel, ell_softmax_kernel

__all__ = ["flat_spec", "to_panel", "to_values", "spmm", "spmm_bias_relu",
           "sddmm", "sparse_softmax"]


def flat_spec(topo) -> P.PanelSpec:
    """The flat API's ``PanelSpec`` at ``panel_api.DEFAULT_BLOCK``, built
    once per topology and kept in its block cache beside the block view
    (so its device index maps are built once per device too)."""
    key = ("spec", *P.DEFAULT_BLOCK)
    spec = topo._block_cache.get(key)
    if spec is None:
        spec = topo._block_cache[key] = P.PanelSpec(topo)
    return spec


def to_panel(spec, values):
    """CSR values ``[..., nnz_pad]`` -> panel ``[..., mb, max_bpr, bm, bk]``
    (0 off the nonzeros); its gradient is the gather back."""
    t, bv = spec.topo, spec.view
    slot = spec.flat_meta(values.device)["slot"]
    lead = values.shape[:-1]
    v = values.reshape(-1, values.shape[-1])[:, : t.nnz]
    flat = v.new_zeros((v.shape[0], bv.dump)).index_copy(1, slot, v)
    return flat.view(*lead, *bv.values_shape)


def to_values(spec, panel):
    """Panel ``[..., mb, max_bpr, bm, bk]`` -> CSR values ``[..., nnz_pad]``
    (padding slots 0); its gradient is the scatter back."""
    t, bv = spec.topo, spec.view
    slot = spec.flat_meta(panel.device)["slot"]
    lead = panel.shape[:-4]
    flat = panel.reshape(-1, bv.dump).index_select(1, slot)
    return F.pad(flat, (0, t.nnz_pad - t.nnz)).view(*lead, t.nnz_pad)


def spmm(topo, values, dense):
    """``values [nnz_pad] x dense [k, n]`` or ``[r, nnz_pad] x [r, k, n]``
    (one launch for all replicas)."""
    spec = flat_spec(topo)
    return P.spmm(spec, to_panel(spec, values), dense)


def spmm_bias_relu(topo, values, dense, bias):
    """The fused ``relu(A @ dense + bias[:, None])`` epilogue of B1."""
    spec = flat_spec(topo)
    return P.spmm_bias_relu(spec, to_panel(spec, values), dense, bias)


def sddmm(topo, lhs, rhs):
    """Sampled ``lhs @ rhs^T`` at the nonzeros: ``[m, d] x [n, d] ->
    [nnz_pad]`` or ``[r, m, d] x [r, n, d] -> [r, nnz_pad]``."""
    spec = flat_spec(topo)
    return to_values(spec, P.sddmm(spec, lhs, rhs))


class _SparseSoftmax(torch.autograd.Function):
    """B5 forward on ``values [R, nnz_pad]``; backward ``p * (g -
    rowsum(p * g))`` (JAX ``_sparse_softmax_bwd``), B5's backward mode."""

    @staticmethod
    def forward(ctx, spec, values):
        meta = spec.flat_meta(values.device)
        p = ell_softmax_kernel(meta["row_offsets"], meta["row_ids"], values,
                               nnz=spec.topo.nnz)
        ctx.spec = spec
        ctx.save_for_backward(p)
        return p

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        spec = ctx.spec
        meta = spec.flat_meta(g.device)
        return None, ell_softmax_bwd_kernel(
            meta["row_offsets"], meta["row_ids"], p, g.contiguous(),
            nnz=spec.topo.nnz)


def sparse_softmax(topo, values):
    """Row softmax over the nonzeros of ``values [nnz_pad]`` or
    ``[r, nnz_pad]`` (one launch for all replicas)."""
    dt = values.dtype
    v = values.to(P.work_dtype(dt)).reshape(-1, values.shape[-1])
    v = v.contiguous()
    p = _SparseSoftmax.apply(flat_spec(topo), v)
    return p.view(values.shape).to(dt)
