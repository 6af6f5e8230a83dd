"""Int8 serving mode: the W8A8 op family over the panel layout
(counterpart of ``sputnik_tpu/ops/int8_api.py``, exported as
``sputnik_tpu_torch.int8``).

Sparse weights are a blockwise int8 panel with one symmetric absmax scale
per tile (``quantize_panel``, once at load time); dense activations are
quantised per tile inside the kernels; each tile product is an exact int32
sum rescaled to f32 before the sum over tiles (W8A8, ~1e-2 relative error
against fp32). The ops quantise on the JAX kernels' grid, which is part of
their result (``kernels/bsr_spmm_int8.py``, ``kernels/flash_sparse_int8.py``):

  * ``spmm_int8`` (kernel B16a), ``spmm_t_int8`` (B16b), ``sddmm_int8``
    (B17) and the fused sparse-flash forward ``attention_int8`` (B18a);
  * ``spmm_qat``: W8A8 forward (B16a) with an int8 backward, ``A_q^T @ g``
    (B16b) for the dense gradient and a straight-through panel gradient
    (B17), cast to the primal dtypes;
  * ``attention_qat(backward="fp32")``: the int8 forward (B18a) with the
    fp32 fused attention's gradients at the same ``(q, k, v)`` (B9
    recomputes ``m`` and ``l``, then B10a or B10b + B10c);
  * ``attention_qat(backward="int8")``, the full-int8 training path: the
    int8 forward (B18a), then the int8 backward from B18a's own ``out``,
    ``m`` and ``l``: dq over the row walk (B18b), dk and dv over the
    transposed walk (B18c), cast to the primal dtypes.

Routes (``ops.api.set_backend``, the JAX package's names):

  * ``"pallas"``: the int8 kernel algebra everywhere: the kernels on CUDA
    tensors, their plain versions on CPU tensors (as interpret mode runs
    the Pallas kernels off a TPU);
  * ``"auto"`` (default): the kernels on CUDA tensors; on CPU tensors JAX's
    off-TPU route: the fp32 oracle on the dequantised panel and fp32 fused
    attention (both ways for ``attention_qat(backward="int8")``);
  * ``"xla"``: that fp32 route on any device.

The activation tile width of B16a / B16b is ``spec.bn``, else JAX's rule:
1024 for >= 4096 columns, 512 for >= 2048, else 128.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .api import _kernel_route, _sddmm_oracle, _spmm_oracle
from .batched_panel import BatchedPanelSpec
from .fused_attention import _fused_bwd, _fused_fwd, fused_sparse_attention
from .kernels.bsr_spmm_int8 import (bsr_sddmm_panel_int8, bsr_spmm_panel_int8,
                                    bsr_spmm_t_panel_int8, div127,
                                    quantize_panel_np)
from .kernels.flash_sparse_int8 import (flash_sparse_attention_fwd_int8,
                                        flash_sparse_bwd_dkv_int8,
                                        flash_sparse_bwd_dq_int8)
from .panel_api import (PanelSpec, _check_rows, _spec, panel_to_values,
                        values_to_panel)

__all__ = ["QuantizedPanel", "quantize_panel", "quantize_panel_tensor",
           "spmm_int8", "spmm_t_int8", "sddmm_int8", "attention_int8",
           "spmm_qat", "attention_qat"]


@dataclasses.dataclass(frozen=True)
class QuantizedPanel:
    """Blockwise int8 panel and its per-tile scales (host or device)."""

    values_q: torch.Tensor      # i8 [mb, max_bpr, bm, bk]
    scales: torch.Tensor        # f32 [mb, max_bpr]

    def to(self, device) -> "QuantizedPanel":
        return QuantizedPanel(self.values_q.to(device), self.scales.to(device))


def quantize_panel(spec: PanelSpec, panel) -> QuantizedPanel:
    """f32 panel -> int8 panel + scales (symmetric per-tile absmax), on the
    host; the arrays equal the JAX package's byte for byte."""
    _ell_spec(spec)
    if isinstance(panel, torch.Tensor):
        panel = panel.detach().cpu().numpy()
    q, s = quantize_panel_np(np.asarray(panel, np.float32))
    return QuantizedPanel(torch.from_numpy(q), torch.from_numpy(s))


def quantize_panel_tensor(panel: torch.Tensor) -> QuantizedPanel:
    """The in-graph quantiser of the quantised-training path (JAX's
    ``quantize_panel_jnp``): per-tile symmetric absmax on the panel's own
    device."""
    p = panel.float()
    scales = div127(p.abs().amax(dim=(-1, -2)))
    safe = torch.where(scales > 0, scales, 1.0)[..., None, None]
    q = torch.clamp(torch.round(p / safe), -127, 127).to(torch.int8)
    return QuantizedPanel(q, scales)


def _dq(qp: QuantizedPanel) -> torch.Tensor:
    """The dequantised f32 panel (the oracle route)."""
    return qp.values_q.float() * qp.scales[:, :, None, None]


def _ell_spec(spec) -> PanelSpec:
    """The int8 ops run on the ELL panel (as JAX's); a compressed spec is
    refused, not misread."""
    spec = _spec(spec)
    if spec.compressed:
        raise ValueError("the int8 ops take the ELL panel layout, not a "
                         "compressed PanelSpec")
    return spec


def _flat(spec: PanelSpec, panel: torch.Tensor) -> torch.Tensor:
    return panel_to_values(spec.topo, panel, spec.bm, spec.bk)


def _tile_width(spec: PanelSpec, n: int) -> int:
    """JAX's activation tile width: ``spec.bn``, else by the column count."""
    return spec.bn or (1024 if n >= 4096 else 512 if n >= 2048 else 128)


def spmm_int8(spec, qp: QuantizedPanel, dense):
    """W8A8 SpMM: int8 weights x the dense ``[n, N]`` operand quantised per
    ``[bk, bn]`` tile -> f32 ``[m, N]``."""
    spec = _ell_spec(spec)
    t, bv = spec.topo, spec.view
    _check_rows("dense", dense, t.n, bv.n_pad, 2)
    if not _kernel_route(dense):
        return _spmm_oracle(t, _flat(spec, _dq(qp)), dense)
    meta = spec.meta(dense.device)
    return bsr_spmm_panel_int8(meta["block_cols"], meta["nblocks"],
                               qp.values_q, qp.scales, dense, rows=t.m,
                               bn=_tile_width(spec, dense.shape[1]))


def spmm_t_int8(spec, qp: QuantizedPanel, g):
    """W8A8 ``A^T @ G`` off the int8 panel through the transposed block
    metadata (no value movement): ``g [m, Q]`` quantised per ``[bm, bq]``
    tile -> f32 ``[n, Q]``."""
    spec = _ell_spec(spec)
    t, bv = spec.topo, spec.view
    _check_rows("g", g, t.m, bv.m_pad, 2)
    if not _kernel_route(g):
        topo_t, perm = t.transpose()
        vals = _flat(spec, _dq(qp))
        perm = torch.as_tensor(perm, dtype=torch.int64, device=vals.device)
        return _spmm_oracle(topo_t, vals.index_select(0, perm), g)
    meta = spec.meta(g.device)
    return bsr_spmm_t_panel_int8(meta["t_src_i"], meta["t_src_s"],
                                 meta["t_nblocks"], qp.values_q, qp.scales, g,
                                 rows=t.n, bq=_tile_width(spec, g.shape[1]))


def sddmm_int8(spec, lhs, rhs):
    """Int8 SDDMM: ``lhs [m, d]`` and ``rhs [n, d]`` quantised per
    ``[bm, 128]`` / ``[bk, 128]`` tile, the sampled product returned as an
    f32 panel (exact 0 at masked and padded slots)."""
    spec = _ell_spec(spec)
    t, bv = spec.topo, spec.view
    _check_rows("lhs", lhs, t.m, bv.m_pad, 2)
    _check_rows("rhs", rhs, t.n, bv.n_pad, 2)
    if not _kernel_route(lhs):
        return values_to_panel(t, _sddmm_oracle(t, lhs, rhs), spec.bm,
                               spec.bk)
    meta = spec.meta(lhs.device)
    return bsr_sddmm_panel_int8(meta["block_cols"], meta["nblocks"], lhs, rhs,
                                meta["mask"])


class _SpMMQAT(torch.autograd.Function):
    """JAX ``spmm_qat``'s ``custom_vjp``: forward quantises the master
    panel in-graph and runs the W8A8 SpMM; backward ``grad_dense = A_q^T @
    g`` (int8) and the straight-through ``grad_panel = sddmm_int8(g,
    dense)``, each cast to its primal's dtype."""

    @staticmethod
    def forward(ctx, spec, panel, dense):
        qp = quantize_panel_tensor(panel)
        ctx.spec, ctx.panel_dtype = spec, panel.dtype
        ctx.save_for_backward(qp.values_q, qp.scales, dense)
        return spmm_int8(spec, qp, dense)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        values_q, scales, dense = ctx.saved_tensors
        spec, need = ctx.spec, ctx.needs_input_grad
        g_panel = g_dense = None
        if need[1]:
            g_panel = sddmm_int8(spec, g, dense).to(ctx.panel_dtype)
        if need[2]:
            g_dense = spmm_t_int8(spec, QuantizedPanel(values_q, scales), g)
            if g_dense.shape[0] != dense.shape[0]:
                g_dense = F.pad(g_dense, (0, 0, 0, dense.shape[0]
                                          - g_dense.shape[0]))
            g_dense = g_dense.to(dense.dtype)
        return None, g_panel, g_dense


def spmm_qat(spec, panel, dense):
    """Differentiable W8A8 SpMM for quantised training: the f32 master
    ``panel [mb, max_bpr, bm, bk]`` is quantised per tile in-graph, times
    ``dense [n, N]`` -> f32 ``[m, N]``; the backward runs the int8
    transposed SpMM and the int8 SDDMM (~1e-2 gradient error against the
    fp32 chain, the W8A8 class)."""
    spec = _ell_spec(spec)
    if panel.dim() != 4:
        raise ValueError(f"panel must be rank 4, got {tuple(panel.shape)}")
    return _SpMMQAT.apply(spec, panel, dense)


def _check_attention(spec: BatchedPanelSpec, q, k, v):
    if q.dim() != 3 or q.shape[0] != spec.R or q.shape[1] != spec.m:
        raise ValueError(f"q {tuple(q.shape)} must be [R={spec.R}, "
                         f"s={spec.m}, hd]")
    if k.shape != (spec.R, spec.n, q.shape[2]) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} must be "
                         f"{(spec.R, spec.n, q.shape[2])}")


def _int8_operands(q, k, v, scale: float):
    """The f32 operands of the int8 flash kernels and the scale the kernels
    apply to q: a q that is not f32 is scaled in its own dtype first, as
    JAX's ``q * scale`` (whose Python scale is rounded to q's dtype before
    the product), and the kernels then quantise that tensor."""
    if q.dtype != torch.float32:
        s = torch.full((), scale, dtype=q.dtype, device=q.device)
        q, scale = (q * s).float(), 1.0
    return (q.contiguous(), k.float().contiguous(), v.float().contiguous(),
            scale)


def _attention_int8(spec: BatchedPanelSpec, q, k, v, scale: float):
    """The int8 flash forward (B18a) on ``_int8_operands`` -> ``(out, m,
    l)``."""
    meta = spec.flash_meta(q.device)
    return flash_sparse_attention_fwd_int8(
        meta["block_cols"], meta["nblocks"], meta["mask_slot"],
        meta["is_partial"], meta["pmask"], q, k, v, heads=spec.heads,
        max_bpr=meta["max_bpr"], scale=scale)


def attention_int8(spec: BatchedPanelSpec, q, k, v, scale=None):
    """Fused int8 sparse-flash attention forward (serving): ``q, k, v
    [R, s, hd]`` -> f32 ``[R, s, hd]``; int8 QK^T and PV, f32 online
    softmax, ~1e-2 relative error. Use the fp32 fused attention to train."""
    _check_attention(spec, q, k, v)
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    scale = float(scale)
    if not _kernel_route(q):
        return fused_sparse_attention(spec, q, k, v, scale=scale)
    return _attention_int8(spec, *_int8_operands(q, k, v, scale))[0]


class _AttentionQAT(torch.autograd.Function):
    """JAX ``_attention_qat``: the int8 forward; the backward is the fp32
    fused attention's at the same ``(q, k, v)`` (straight-through: the int8
    rounding counts as the identity)."""

    @staticmethod
    def forward(ctx, spec, q, k, v, scale):
        ctx.spec, ctx.scale = spec, scale
        ctx.save_for_backward(q, k, v)
        return attention_int8(spec, q, k, v, scale=scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        spec, scale = ctx.spec, ctx.scale
        qf, kf, vf = (x.float().contiguous() for x in (q, k, v))
        g = g.float().contiguous()
        out, m, l = _fused_fwd(spec, qf, kf, vf, scale, 1)
        D = (g * out).sum(-1)
        dq, dk, dv = _fused_bwd(spec, qf, kf, vf, g, m, l, D, scale, 1)
        return (None, (dq * scale).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None)


class _AttentionInt8Train(torch.autograd.Function):
    """JAX ``_attention_int8_train``: the int8 forward (B18a); the backward
    recomputes p from the forward's own ``m`` and ``l`` on the same codes and
    runs every contraction on int8: dq (B18b), dk and dv (B18c)."""

    @staticmethod
    def forward(ctx, spec, q, k, v, scale):
        qf, kf, vf, q_scale = _int8_operands(q, k, v, scale)
        out, m, l = _attention_int8(spec, qf, kf, vf, q_scale)
        ctx.spec, ctx.scale, ctx.q_scale = spec, scale, q_scale
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        ctx.save_for_backward(qf, kf, vf, out, m, l)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        qf, kf, vf, out, m, l = ctx.saved_tensors
        spec, dev = ctx.spec, qf.device
        g = g.float().contiguous()
        D = (g * out).sum(-1)
        ops = (qf, kf, vf, g, m, l, D)
        kw = dict(heads=spec.heads, scale=ctx.q_scale)
        fm, bm = spec.flash_meta(dev), spec.flash_bwd_meta(dev)
        dq = flash_sparse_bwd_dq_int8(
            fm["block_cols"], fm["nblocks"], fm["mask_slot"],
            fm["is_partial"], fm["pmask"], *ops, max_bpr=fm["max_bpr"], **kw)
        dk, dv = flash_sparse_bwd_dkv_int8(
            bm["t_src_i"], bm["t_nblocks"], bm["t_mask_slot"],
            bm["t_is_partial"], bm["pmask"], *ops, max_bpc=bm["max_bpc"],
            **kw)
        q_dt, k_dt, v_dt = ctx.dtypes
        return (None, (dq * ctx.scale).to(q_dt), dk.to(k_dt), dv.to(v_dt),
                None)


def attention_qat(spec: BatchedPanelSpec, q, k, v, scale=None,
                  backward: str = "fp32"):
    """Quantisation-aware-training sparse attention: the int8 fused
    forward (what serving runs), with a choice of backward:

    * ``backward="fp32"`` (default): the fp32 fused gradients at the same
      ``(q, k, v)`` (straight-through, the fake-quant recipe);
    * ``backward="int8"``: the full-int8 training path: p is recomputed
      from the int8 forward's stats on the same per-tile codes, and the
      backward's four contractions (QK^T, GV^T, dS K and dS^T Q, P^T G) run
      on int8 codes (B18b, B18c); a gradient error against fp32 of a few
      1e-2 of max|grad| (the W8A8 class), growing with the sequence to
      ~1e-1 at 2048. On CPU tensors under ``"auto"``, and under ``"xla"``,
      it is the fp32 fused attention both ways, as JAX's off-TPU route.

    The gradients come back in the primal dtypes."""
    _check_attention(spec, q, k, v)
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    if backward == "int8":
        if not _kernel_route(q):
            return fused_sparse_attention(spec, q, k, v, scale=float(scale))
        return _AttentionInt8Train.apply(spec, q, k, v, float(scale))
    if backward != "fp32":
        raise ValueError(f"backward must be 'fp32' or 'int8', "
                         f"got {backward!r}")
    return _AttentionQAT.apply(spec, q, k, v, float(scale))
