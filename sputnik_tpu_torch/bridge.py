"""Carry JAX/flax parameters into the port's modules.

A flax parameter tree (nested dicts of arrays; anything ``numpy.asarray``
takes) becomes a ``state_dict`` for ``load_state_dict``:

  * flax ``nn.Dense`` kernels are ``[in, out]``; ``nn.Linear.weight`` is
    ``[out, in]``, so kernels are transposed;
  * flax ``nn.LayerNorm`` ``scale`` is ``nn.LayerNorm.weight``;
  * flax ``layer_<i>`` submodules are ``layers.<i>``;
  * a ``SparseLM``'s ``embed.embedding`` ``[vocab, h]`` is
    ``nn.Embedding.weight`` as it is (no transpose);
  * ``SparseLinear`` values go JAX panel (JAX tiles, read from the panel's
    shape) -> CSR values -> the port's panel (the port's tiles). Panel
    bytes are never copied: the two packages tile differently.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .ops import panel_api as P

__all__ = ["transformer_state_dict", "lm_state_dict",
           "sparse_linear_state_dict", "sparse_attention_state_dict"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _unwrap(params):
    return params["params"] if "params" in params else params


def transformer_state_dict(params) -> dict:
    """Flax ``SparseTransformer`` params -> the port's ``SparseTransformer``
    state_dict (dense layers and LayerNorms; the sparse attention core has
    no parameters)."""
    out = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                walk(val, path + [re.sub(r"^layer_(\d+)$", r"layers.\1",
                                         key)])
                continue
            name = ".".join(path)
            if key == "kernel":
                out[f"{name}.weight"] = _t(np.asarray(val).T)
            elif key == "scale":
                out[f"{name}.weight"] = _t(val)
            elif key == "bias":
                out[f"{name}.bias"] = _t(val)
            else:
                raise KeyError(f"unexpected flax leaf {name}.{key}")

    walk(_unwrap(params), [])
    return out


def lm_state_dict(params) -> dict:
    """Flax ``SparseLM`` params -> the port's ``SparseLM`` state_dict:
    ``embed``, ``ln_f`` (a LayerNorm), the untied ``lm_head`` (transposed)
    and ``core.*`` through ``transformer_state_dict``."""
    p = _unwrap(params)
    out = {"embed.weight": _t(p["embed"]["embedding"])}
    out.update({f"core.{k}": v
                for k, v in transformer_state_dict(p["core"]).items()})
    if "ln_f" in p:
        out["ln_f.weight"] = _t(p["ln_f"]["scale"])
        out["ln_f.bias"] = _t(p["ln_f"]["bias"])
    if "lm_head" in p:
        out["lm_head.weight"] = _t(np.asarray(p["lm_head"]["kernel"]).T)
    return out


def sparse_linear_state_dict(params, linear) -> dict:
    """Flax ``SparseLinear`` params (panel layout) -> the port's
    ``SparseLinear`` state_dict."""
    params = _unwrap(params)
    panel = np.asarray(params["values"], np.float32)
    if panel.ndim != 4:
        raise ValueError(f"expected a [mb, max_bpr, bm, bk] panel, got "
                         f"{panel.shape}")
    topo = linear.topology
    vals = P.panel_to_values_np(topo, panel, panel.shape[2], panel.shape[3])
    sd = {"values": _t(P.values_to_panel_np(topo, vals, linear.spec.bm,
                                            linear.spec.bk))}
    if "bias" in params:
        sd["bias"] = _t(params["bias"])
    return sd


def sparse_attention_state_dict(params, attention) -> dict:
    """Flax ``SparseAttention`` params -> the port's ``SparseAttention``
    state_dict (its four ``SparseLinear`` projections)."""
    params = _unwrap(params)
    out = {}
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        sd = sparse_linear_state_dict(params[name], getattr(attention, name))
        out.update({f"{name}.{k}": v for k, v in sd.items()})
    return out
