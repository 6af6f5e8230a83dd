"""Sparse transformer (counterpart of ``sputnik_tpu/models/transformer.py``).

The reference's transformer driver scenario: per-batch-element masks (a
``ManyMaskTopology`` converted to CSR once, at construction), fused QKV
projection in the head-interleaved layout, MLP, N stacked layers,
optional pre-LN residual blocks. Activations are ``[b, s, h]``; attention
replicas are ``[b*heads, s, hd]`` with ``r = b_idx*heads + h``.

Attention layouts, both trainable: ``"flash"`` (default) runs the
sparse-flash kernels, forward and backward, at any sequence length;
``"xla"`` is the dense-masked plain path (outside any kernel, as in JAX).
``"panel"``, ``"csr"`` and ``"auto"`` are not ported.
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

from .. import many_mask as mm
from ..ops.batched_panel import BatchedPanelSpec
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
]

_NOT_PORTED = {
    "panel": "the batched panel kernels, ROADMAP A7 / B6-B8",
    "csr": "the many-mask autograd path, ROADMAP A7",
    "auto": "the xla/flash crossover, to be re-measured on the H100 "
            "(ROADMAP A9)",
}
_LN_EPS = 1e-6   # flax nn.LayerNorm's default


def _linear(fan_in: int, fan_out: int, generator, device) -> nn.Linear:
    """``nn.Linear`` initialised like flax ``nn.Dense``: LeCun-normal
    (truncated at 2 std) weight, zero bias."""
    lin = nn.Linear(fan_in, fan_out)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
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
    flash layout tiles the masks at the kernel's 64 x 64."""

    def __init__(self, mask_topology: mm.ManyMaskTopology, num_heads: int,
                 layout: str = "flash"):
        super().__init__()
        if layout in _NOT_PORTED:
            raise NotImplementedError(
                f"layout={layout!r} is not ported yet — {_NOT_PORTED[layout]}")
        if layout not in ("flash", "xla"):
            raise ValueError(f"unknown layout {layout!r}")
        self.mask_topology = mask_topology
        self.num_heads = num_heads
        self.layout = layout

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
        if self.layout == "xla":
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
        warm_flash_meta(spec, q.device, backward=torch.is_grad_enabled(),
                        hd=hd)
        ctx = fused_sparse_attention(spec, fold(q), fold(k), fold(v),
                                     scale=scale, group=h // kv)
        return ctx.reshape(b, h, s, hd).transpose(1, 2).reshape(b, s, h * hd)


class SparseSelfAttention(nn.Module):
    """Fused-QKV self-attention block; ``num_kv_heads`` < ``num_heads``
    gives grouped-query attention."""

    def __init__(self, mask_topology: mm.ManyMaskTopology, hidden_size: int,
                 num_heads: int, num_kv_heads: Optional[int] = None,
                 attention_layout: str = "flash", *,
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
                                        attention_layout)
        self.dense = _linear(hidden_size, hidden_size, generator, device)

    def forward(self, x):
        b, s, hsz = x.shape
        if hsz != self.hidden_size:
            raise ValueError(f"hidden {hsz} != {self.hidden_size}")
        h, kv = self.num_heads, self.num_kv_heads
        hd = hsz // h
        qkv = self.query_key_value(x)
        if kv == h:
            # head-interleaved layout: [b, s, heads, (q | k | v)]
            q, k, v = qkv.reshape(b, s, h, 3 * hd).split(hd, dim=-1)
        else:
            q = qkv[..., : h * hd].reshape(b, s, h, hd)
            k = qkv[..., h * hd: (h + kv) * hd].reshape(b, s, kv, hd)
            v = qkv[..., (h + kv) * hd:].reshape(b, s, kv, hd)
        return self.dense(self.core(q, k, v))


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
        y = self.to_4h(x)
        if self.activation == "gelu":
            y = F.gelu(y, approximate="tanh")
        elif self.activation == "relu":
            y = F.relu(y)
        return self.to_h(y)


class TransformerLayer(nn.Module):
    """Attention -> MLP; ``use_residual``/``use_layernorm`` give the pre-LN
    block."""

    def __init__(self, mask_topology: mm.ManyMaskTopology, hidden_size: int,
                 num_heads: int, ffn_hidden_size: int,
                 num_kv_heads: Optional[int] = None,
                 activation: Optional[str] = None, use_residual: bool = False,
                 use_layernorm: bool = False,
                 attention_layout: str = "flash", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.use_residual = use_residual

        def ln():
            return (nn.LayerNorm(hidden_size, eps=_LN_EPS, device=device)
                    if use_layernorm else nn.Identity())

        self.ln_attn = ln()
        self.self_attention = SparseSelfAttention(
            mask_topology, hidden_size, num_heads, num_kv_heads,
            attention_layout, generator=generator, device=device)
        self.ln_mlp = ln()
        self.mlp = MLP(hidden_size, ffn_hidden_size, activation,
                       generator=generator, device=device)

    def forward(self, x):
        attn = self.self_attention(self.ln_attn(x))
        x = x + attn if self.use_residual else attn
        mlp = self.mlp(self.ln_mlp(x))
        return x + mlp if self.use_residual else mlp


class SparseTransformer(nn.Module):
    """N sparse-attention layers over per-batch masks."""

    def __init__(self, mask_topology: mm.ManyMaskTopology, num_layers: int,
                 hidden_size: int, num_heads: int, ffn_hidden_size: int,
                 num_kv_heads: Optional[int] = None,
                 activation: Optional[str] = None, use_residual: bool = False,
                 use_layernorm: bool = False,
                 attention_layout: str = "flash", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.mask_topology = mask_topology
        self.layers = nn.ModuleList([
            TransformerLayer(mask_topology, hidden_size, num_heads,
                             ffn_hidden_size, num_kv_heads, activation,
                             use_residual, use_layernorm, attention_layout,
                             generator=generator, device=device)
            for _ in range(num_layers)])

    @classmethod
    def from_masks(cls, masks: np.ndarray, **kwargs) -> "SparseTransformer":
        """Build over per-batch dense 0/1 masks ``[b, s, s]``, converted to
        CSR once, here."""
        return cls(mm.ManyMaskTopology.from_dense_masks(masks), **kwargs)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x
