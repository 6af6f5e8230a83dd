"""Sparse transformer (counterpart of ``sputnik_tpu/models/transformer.py``).

The reference's transformer driver scenario: per-batch-element masks (a
``ManyMaskTopology`` converted to CSR once, at construction), fused QKV
projection in the head-interleaved layout, MLP, N stacked layers,
optional pre-LN residual blocks. Activations are ``[b, s, h]``; attention
replicas are ``[b*heads, s, hd]`` with ``r = b_idx*heads + h``.

Attention layouts, all trainable: ``"flash"`` (default) runs the
sparse-flash kernels, forward and backward, at any sequence length;
``"panel"`` runs the batched panel chain SDDMM -> softmax -> SpMM over the
per-mask block metadata (kernels B7, B6; B6-B8 in the backward); ``"csr"``
the flat many-mask ops (plain PyTorch, as in JAX); ``"xla"`` the
dense-masked plain path (outside any kernel, as in JAX). ``"auto"`` is not
ported. ``moe`` / ``moe_every`` replace every ``moe_every``-th layer's MLP
by a ``SparseMoE`` of its own (``models/moe.py``).
The dense layers are ``nn.Linear``/``nn.LayerNorm`` with flax's defaults
(LayerNorm epsilon 1e-6, tanh-approximated gelu, LeCun-normal kernels).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import many_mask as mm
from ..ops.batched_panel import (BatchedPanelSpec, sddmm_bh, spmm_bh,
                                 sparse_softmax_bh)
from ..ops.fused_attention import fused_sparse_attention, warm_flash_meta
from ..ops.kernels.flash_sparse import KERNEL_TILE

__all__ = [
    "SparseCoreAttention",
    "SparseSelfAttention",
    "MLP",
    "TransformerLayer",
    "SparseTransformer",
    "cached_batched_spec",
    "dense_masks_for",
    "divide",
    "split_tensor_along_last_dim",
]

_LAYOUTS = ("flash", "xla", "panel", "csr", "auto")
_LN_EPS = 1e-6   # flax nn.LayerNorm's default
# sequence length at which layout="auto" leaves the dense-masked xla layout
# for the flash kernels, on every device: the least tested length from
# which flash was no slower, forward and forward + backward, in the
# medians of five runs of chip_smoke.py's sweep (phase 3n: the driver's
# widths, b=4, h=512, 8 heads, 2 layers, s = 128 ... 4096) on an H100 80GB
# HBM3 at 700 W; single runs read 128 to 1024. Below it both layouts are
# host-bound and level within their spread.
_XLA_FLASH_CROSSOVER = 512


def _dense(lin: nn.Linear, x):
    """``lin`` on ``x`` as JAX applies a Dense: activation and weight meet
    in their promoted dtype, so an f32 activation and bf16-stored weights
    (``SparseDecoder.cast_params``) give an f32 product of the weights'
    exact values; where the dtypes agree it is ``lin(x)``."""
    dt = torch.promote_types(x.dtype, lin.weight.dtype)
    b = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x.to(dt), lin.weight.to(dt), b)


def _norm(ln, x):
    """``ln`` (``nn.LayerNorm`` or ``nn.Identity``) on ``x`` as flax's
    ``nn.LayerNorm`` promotes: a narrower activation is upcast to the
    parameters' dtype first, so the statistics, the parameters and the
    result are f32 (the serving decoders' ``_layernorm`` follows JAX's
    plain serving function instead, which rounds its statistics)."""
    if isinstance(ln, nn.Identity):
        return ln(x)
    return ln(x.to(torch.promote_types(x.dtype, ln.weight.dtype)))


def divide(numerator: int, denominator: int) -> int:
    """Exact division, raising ``ValueError`` when it is not."""
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")
    return numerator // denominator


def split_tensor_along_last_dim(tensor, num_partitions: int):
    """Split the last dimension into ``num_partitions`` equal chunks
    (``torch.split`` views); ``ValueError`` when it does not divide."""
    return torch.split(tensor, divide(tensor.shape[-1], num_partitions),
                       dim=-1)


def _linear(fan_in: int, fan_out: int, generator, device,
            bias: bool = True) -> nn.Linear:
    """``nn.Linear`` initialised like flax ``nn.Dense``: LeCun-normal
    (truncated at 2 std) weight, zero bias."""
    lin = nn.Linear(fan_in, fan_out, bias=bias)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        if bias:
            lin.bias.zero_()
    return lin.to(device)


def cached_batched_spec(mt: mm.ManyMaskTopology, heads: int, bm: int,
                        bk: int) -> BatchedPanelSpec:
    """The ``(heads, bm, bk)``-keyed ``BatchedPanelSpec`` cache attached to
    a mask topology: one spec (and one copy of its device metadata) shared
    by every layer bound to the same masks."""
    cached = mt.__dict__.setdefault("_batched_panel_specs", {})
    key = (heads, bm, bk)
    if key not in cached:
        cached[key] = BatchedPanelSpec.from_many_mask(mt, heads=heads, bm=bm,
                                                      bk=bk)
    return cached[key]


def dense_masks_for(mt: mm.ManyMaskTopology, device) -> torch.Tensor:
    """``[b, s, s]`` 0/1 masks for the xla layout, cached per device on the
    mask topology."""
    cached = mt.__dict__.setdefault("_dense_masks", {})
    device = torch.device(device)
    if device not in cached:
        np_m = np.stack([t.to_dense_mask() for t in mt.topologies])
        cached[device] = torch.as_tensor(np_m, dtype=torch.float32,
                                         device=device)
    return cached[device]


class SparseCoreAttention(nn.Module):
    """Masked softmax attention with per-batch masks (no parameters). The
    flash and panel layouts tile the masks at 64 x 64 and share one
    ``BatchedPanelSpec``. ``layout="auto"`` runs ``"xla"`` below
    ``_XLA_FLASH_CROSSOVER`` tokens, ``"flash"`` from there on.
    ``flash_stream`` (``None`` or ``"bf16"``) is a TPU-only switch of the
    JAX package: accepted, not checked, and without effect here."""

    def __init__(self, mask_topology: mm.ManyMaskTopology, num_heads: int,
                 layout: str = "flash", flash_stream: Optional[str] = None):
        super().__init__()
        if layout not in _LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}")
        self.mask_topology = mask_topology
        self.num_heads = num_heads
        self.layout = layout
        self.flash_stream = flash_stream

    def forward(self, q, k, v):
        """q: ``[b, s, heads, head_dim]``; k, v: same, or with fewer
        (grouped-query) KV heads dividing ``heads`` -> ``[b, s, h]``."""
        mt = self.mask_topology
        b, s, h, hd = q.shape
        if b != mt.b:
            raise ValueError(f"batch {b} != mask batch {mt.b}")
        if s != mt.m:
            raise ValueError(f"seq {s} != mask rows {mt.m}")
        kv = k.shape[2]
        if kv == 0 or h % kv:
            raise ValueError(f"kv heads {kv} must divide heads {h}")
        scale = 1.0 / float(np.sqrt(hd))
        layout = self.layout
        if layout == "auto":
            layout = "xla" if s < _XLA_FLASH_CROSSOVER else "flash"
        if layout == "xla":
            if kv != h:
                k = k.repeat_interleave(h // kv, dim=2)
                v = v.repeat_interleave(h // kv, dim=2)
            live = dense_masks_for(mt, q.device)[:, None] != 0  # [b,1,s,s]
            sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
            sc = torch.where(live, sc, -1e30)
            w = torch.softmax(sc, dim=-1) * live
            ctx = torch.einsum("bhqk,bkhd->bqhd", w, v)
            return ctx.reshape(b, s, h * hd)

        def fold(x):  # [b, s, hx, hd] -> [b*hx, s, hd]
            return x.transpose(1, 2).reshape(b * x.shape[2], s, hd)

        spec = cached_batched_spec(mt, h, KERNEL_TILE, KERNEL_TILE)
        if layout == "flash":
            # GQA native in the kernel: query replicas read their KV replica
            warm_flash_meta(spec, q.device, backward=torch.is_grad_enabled(),
                            hd=hd)
            ctx = fused_sparse_attention(spec, fold(q), fold(k), fold(v),
                                         scale=scale, group=h // kv)
        else:
            # the unfused chains index K/V per query replica
            if kv != h:
                k = k.repeat_interleave(h // kv, dim=2)
                v = v.repeat_interleave(h // kv, dim=2)
            q3, k3, v3 = fold(q), fold(k), fold(v)
            if layout == "panel":
                w = sparse_softmax_bh(spec, sddmm_bh(spec, q3, k3) * scale)
                ctx = spmm_bh(spec, w, v3)
            else:
                w = mm.sparse_softmax_many_mask(
                    mt, mm.sddmm_many_mask(mt, q3, k3) * scale)
                ctx = mm.spmm_many_mask(mt, w, v3)
        return ctx.reshape(b, h, s, hd).transpose(1, 2).reshape(b, s, h * hd)


class SparseSelfAttention(nn.Module):
    """Fused-QKV self-attention block; ``num_kv_heads`` < ``num_heads``
    gives grouped-query attention."""

    def __init__(self, mask_topology: mm.ManyMaskTopology, hidden_size: int,
                 num_heads: int, num_kv_heads: Optional[int] = None,
                 attention_layout: str = "flash",
                 flash_stream: Optional[str] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError("hidden_size must divide by num_heads")
        kv = num_kv_heads or num_heads
        if num_heads % kv:
            raise ValueError(
                f"num_kv_heads {kv} must divide num_heads {num_heads}")
        self.hidden_size, self.num_heads, self.num_kv_heads = (
            hidden_size, num_heads, kv)
        hd = hidden_size // num_heads
        self.query_key_value = _linear(hidden_size, (num_heads + 2 * kv) * hd,
                                       generator, device)
        self.core = SparseCoreAttention(mask_topology, num_heads,
                                        attention_layout, flash_stream)
        self.dense = _linear(hidden_size, hidden_size, generator, device)

    def forward(self, x):
        b, s, hsz = x.shape
        if hsz != self.hidden_size:
            raise ValueError(f"hidden {hsz} != {self.hidden_size}")
        h, kv = self.num_heads, self.num_kv_heads
        hd = hsz // h
        qkv = _dense(self.query_key_value, x)
        if kv == h:
            # head-interleaved layout: [b, s, heads, (q | k | v)]
            q, k, v = qkv.reshape(b, s, h, 3 * hd).split(hd, dim=-1)
        else:
            q = qkv[..., : h * hd].reshape(b, s, h, hd)
            k = qkv[..., h * hd: (h + kv) * hd].reshape(b, s, kv, hd)
            v = qkv[..., (h + kv) * hd:].reshape(b, s, kv, hd)
        return _dense(self.dense, self.core(q, k, v))


class MLP(nn.Module):
    """Two dense projections, optional gelu (tanh form) or relu between."""

    def __init__(self, hidden_size: int, ffn_hidden_size: int,
                 activation: Optional[str] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if activation not in (None, "gelu", "relu"):
            raise ValueError(f"unknown activation {activation}")
        self.activation = activation
        self.to_4h = _linear(hidden_size, ffn_hidden_size, generator, device)
        self.to_h = _linear(ffn_hidden_size, hidden_size, generator, device)

    def forward(self, x):
        y = _dense(self.to_4h, x)
        if self.activation == "gelu":
            y = F.gelu(y, approximate="tanh")
        elif self.activation == "relu":
            y = F.relu(y)
        return _dense(self.to_h, y)


class TransformerLayer(nn.Module):
    """Attention -> MLP; ``use_residual``/``use_layernorm`` give the pre-LN
    block. With ``moe`` (the keyword arguments of a ``SparseMoE``) the MLP
    is a ``SparseMoE`` of this layer's own: its own router and expert
    values."""

    def __init__(self, mask_topology: mm.ManyMaskTopology, hidden_size: int,
                 num_heads: int, ffn_hidden_size: int,
                 num_kv_heads: Optional[int] = None,
                 activation: Optional[str] = None, use_residual: bool = False,
                 use_layernorm: bool = False,
                 attention_layout: str = "flash",
                 moe: Optional[dict] = None,
                 flash_stream: Optional[str] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.use_residual = use_residual

        def ln():
            return (nn.LayerNorm(hidden_size, eps=_LN_EPS, device=device)
                    if use_layernorm else nn.Identity())

        self.ln_attn = ln()
        self.self_attention = SparseSelfAttention(
            mask_topology, hidden_size, num_heads, num_kv_heads,
            attention_layout, flash_stream, generator=generator,
            device=device)
        self.ln_mlp = ln()
        if moe is not None:
            from .moe import SparseMoE

            self.mlp = SparseMoE(**moe, generator=generator, device=device)
        else:
            self.mlp = MLP(hidden_size, ffn_hidden_size, activation,
                           generator=generator, device=device)

    def forward(self, x):
        attn = self.self_attention(_norm(self.ln_attn, x))
        x = x + attn if self.use_residual else attn
        mlp = self.mlp(_norm(self.ln_mlp, x))
        return x + mlp if self.use_residual else mlp


class SparseTransformer(nn.Module):
    """N sparse-attention layers over per-batch masks.

    ``moe`` (the keyword arguments of a ``SparseMoE``: ``topo_in``,
    ``topo_out``, ``num_experts``, ...) with ``moe_every = k`` makes layers
    ``k-1, 2k-1, ...`` MoE layers, each with its own router and expert
    values (k = 2 is the Switch default). ``aux_loss()`` sums their router
    aux losses of the last forward. Serving decoders reject MoE models.

    ``remat=True`` runs each layer under ``torch.utils.checkpoint`` (the
    non-reentrant form) while grad is enabled: its activations are
    recomputed in the backward instead of stored, one more forward of
    work for memory that no longer grows with the layers' activations.
    The parameters, and so state dicts, are the same in both modes; a MoE
    layer's aux loss keeps its gradient (the recompute sets the same
    ``aux_loss`` / ``last_experts`` again)."""

    def __init__(self, mask_topology: mm.ManyMaskTopology, num_layers: int,
                 hidden_size: int, num_heads: int, ffn_hidden_size: int,
                 num_kv_heads: Optional[int] = None,
                 activation: Optional[str] = None, use_residual: bool = False,
                 use_layernorm: bool = False,
                 attention_layout: str = "flash",
                 moe: Optional[dict] = None, moe_every: int = 0,
                 flash_stream: Optional[str] = None, remat: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if moe_every and moe is None:
            raise ValueError("moe_every set but no moe module given")
        self.mask_topology = mask_topology
        self.num_layers, self.hidden_size = num_layers, hidden_size
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.attention_layout, self.moe_every = attention_layout, moe_every
        self.flash_stream, self.remat = flash_stream, remat
        self.layers = nn.ModuleList([
            TransformerLayer(mask_topology, hidden_size, num_heads,
                             ffn_hidden_size, num_kv_heads, activation,
                             use_residual, use_layernorm, attention_layout,
                             moe if (moe_every and i % moe_every
                                     == moe_every - 1) else None,
                             flash_stream, generator=generator,
                             device=device)
            for i in range(num_layers)])

    @classmethod
    def from_masks(cls, masks: np.ndarray, **kwargs) -> "SparseTransformer":
        """Build over per-batch dense 0/1 masks ``[b, s, s]``, converted to
        CSR once, here."""
        return cls(mm.ManyMaskTopology.from_dense_masks(masks), **kwargs)

    def forward(self, x):
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, use_reentrant=False)
            else:
                x = layer(x)
        return x

    def aux_loss(self) -> torch.Tensor:
        """The sum of the MoE layers' router aux losses from the last
        forward (0 without MoE layers)."""
        losses = [layer.mlp.aux_loss for layer in self.layers
                  if getattr(layer.mlp, "aux_loss", None) is not None]
        if not losses:
            return torch.zeros((), device=next(self.parameters()).device)
        return torch.stack(losses).sum()
