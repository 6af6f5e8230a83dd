"""Carry JAX/flax parameters into the port's modules.

A flax parameter tree (nested dicts of arrays; anything ``numpy.asarray``
takes) becomes a ``state_dict`` for ``load_state_dict``:

  * flax ``nn.Dense`` kernels are ``[in, out]``; ``nn.Linear.weight`` is
    ``[out, in]``, so kernels are transposed;
  * flax ``nn.LayerNorm`` ``scale`` is ``nn.LayerNorm.weight``;
  * flax ``layer_<i>`` submodules are ``layers.<i>``;
  * a ``SparseLM``'s ``embed.embedding`` ``[vocab, h]`` is
    ``nn.Embedding.weight`` as it is (no transpose);
  * ``SparseLinear`` values and ``SparseMoE`` expert values (per expert)
    go JAX panel (JAX tiles, read from the panel's shape) -> CSR values ->
    the port's panel (the port's tiles). Panel bytes are never copied: the
    two packages tile differently. CSR-layout values cross as they are;
  * an int8 ``QuantizedPanel`` crosses as it is (``quantized_panel``): its
    tiles are its quantisation grid, so the port uses the JAX panel's
    ``(bm, bk)``;
  * an expert-parallel ``SparseMoE`` on a rank takes its own experts'
    slice of JAX's ``[E, ...]`` values (``SparseMoE.experts``);
  * JAX's stacked pipeline stages (``stack_stage_params`` of flax
    ``TransformerLayer`` params) become the port's stacked dict
    (``stacked_stage_state_dict``).

A flax gradient tree has the params' structure, so the same functions map
JAX gradients onto the port's parameter names.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .ops import panel_api as P

__all__ = ["transformer_state_dict", "lm_state_dict", "moe_state_dict",
           "sparse_linear_state_dict", "sparse_attention_state_dict",
           "stacked_stage_state_dict", "quantized_panel"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _unwrap(params):
    return params["params"] if "params" in params else params


def _expert_panels(moe, panels, which: str) -> torch.Tensor:
    """JAX expert-bank panels ``[E, mb, max_bpr, bm, bk]`` -> the port's,
    the experts ``moe`` holds."""
    panels = np.asarray(panels, np.float32)
    if panels.ndim != 5 or panels.shape[0] != moe.num_experts:
        raise ValueError(f"expected [{moe.num_experts}, mb, max_bpr, bm, bk] "
                         f"expert panels, got {panels.shape}")
    topo = moe.topo_in if which == "in" else moe.topo_out
    flat = [P.panel_to_values_np(topo, p, panels.shape[3], panels.shape[4])
            for p in panels[moe.experts.start:moe.experts.stop]]
    return _t(moe.panel_values(flat, which))


def moe_state_dict(params, moe) -> dict:
    """Flax ``SparseMoE`` params -> the port's ``SparseMoE`` state_dict (the
    router kernel transposed, the expert values re-tiled per expert). An
    expert-parallel module on a rank gets its own experts' values."""
    p = _unwrap(params)
    return {"router.weight": _t(np.asarray(p["router"]["kernel"]).T),
            "w_in_values": _expert_panels(moe, p["w_in_values"], "in"),
            "w_out_values": _expert_panels(moe, p["w_out_values"], "out")}


def transformer_state_dict(params, model=None) -> dict:
    """Flax ``SparseTransformer`` (or ``TransformerLayer``) params -> the
    port's state_dict (dense layers, LayerNorms and MoE routers; the sparse
    attention core has no parameters). MoE expert values need ``model``,
    the port's module: its ``SparseMoE`` layers hold the topologies, the
    port's tiles and, expert-parallel, the experts a rank holds."""
    out = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                walk(val, path + [re.sub(r"^layer_(\d+)$", r"layers.\1",
                                         key)])
                continue
            name = ".".join(path)
            if key in ("w_in_values", "w_out_values"):
                if model is None:
                    raise ValueError(f"{name}.{key}: MoE expert values need "
                                     f"the port's model (model=...)")
                out[f"{name}.{key}"] = _expert_panels(
                    model.get_submodule(name), val,
                    "in" if key == "w_in_values" else "out")
            elif key == "kernel":
                out[f"{name}.weight"] = _t(np.asarray(val).T)
            elif key == "scale":
                out[f"{name}.weight"] = _t(val)
            elif key == "bias":
                out[f"{name}.bias"] = _t(val)
            else:
                raise KeyError(f"unexpected flax leaf {name}.{key}")

    walk(_unwrap(params), [])
    return out


def _index(node, i):
    """Leaf ``i`` of every leading axis in a (nested) parameter dict."""
    if hasattr(node, "items"):
        return {k: _index(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def stacked_stage_state_dict(stacked, layer=None, position=None) -> dict:
    """JAX's stacked pipeline stages (``stack_stage_params`` of flax
    ``TransformerLayer`` params: every leaf ``[ndev, ...]``) -> the port's
    stacked dict ``{name: [ndev, ...]}`` for ``pipeline_apply`` with
    ``functional_call`` on ``layer`` (the port's ``TransformerLayer``,
    needed for MoE expert values). ``position``: only that stage, as a
    rank holds it (``[1, ...]``)."""
    stacked = _unwrap(stacked)
    leaf = stacked
    while hasattr(leaf, "items"):
        leaf = next(iter(leaf.values()))
    stages = range(np.shape(leaf)[0]) if position is None else [position]
    per = [transformer_state_dict(_index(stacked, i), layer) for i in stages]
    return {k: torch.stack([sd[k] for sd in per]) for k in per[0]}


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
    """Flax ``SparseLinear`` params, panel or csr layout -> the port's
    ``SparseLinear`` state_dict, in the port layer's layout."""
    params = _unwrap(params)
    values = np.asarray(params["values"], np.float32)
    topo = linear.topology
    if values.ndim == 4:            # a JAX panel, at JAX's tiles
        values = P.panel_to_values_np(topo, values, values.shape[2],
                                      values.shape[3])
    elif values.shape != (topo.nnz_pad,):
        raise ValueError(f"expected a [mb, max_bpr, bm, bk] panel or "
                         f"[{topo.nnz_pad}] csr values, got {values.shape}")
    sd = {"values": _t(linear.to_layout(values))}
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


def quantized_panel(values_q, scales, device=None):
    """A JAX ``QuantizedPanel``'s arrays (anything ``numpy.asarray`` takes:
    int8 ``[mb, max_bpr, bm, bk]`` and f32 ``[mb, max_bpr]``) -> the port's
    ``int8.QuantizedPanel``, byte for byte, on ``device`` (the host if
    None). With the same ``(bm, bk)`` the port's ``int8.quantize_panel``
    gives the same arrays."""
    from .ops.int8_api import QuantizedPanel

    values_q = np.asarray(values_q)
    scales = np.asarray(scales)
    if values_q.dtype != np.int8 or values_q.ndim != 4:
        raise ValueError(f"values_q must be an int8 [mb, max_bpr, bm, bk] "
                         f"array, got {values_q.dtype} {values_q.shape}")
    if scales.shape != values_q.shape[:2]:
        raise ValueError(f"scales {scales.shape} != {values_q.shape[:2]}")
    qp = QuantizedPanel(torch.from_numpy(values_q.copy()),
                        torch.from_numpy(scales.astype(np.float32)))
    return qp if device is None else qp.to(device)
