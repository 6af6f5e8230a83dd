"""SparseLinear: a linear layer with a block-sparse weight matrix
(counterpart of ``sputnik_tpu/models/linear.py``).

The weight ``W_sp [out, in]`` has a static ``SparseTopology``; the trainable
values live in the block panel (``layout="panel"``) and the forward is ONE
panel SpMM launch with every batch dim folded into the dense columns. The
bias (and ReLU, with ``fuse_relu``) is applied in the kernel's epilogue.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops import panel_api as P
from ..topology import SparseTopology

__all__ = ["SparseLinear"]


class SparseLinear(nn.Module):
    """``y = act(W_sp @ x^T + b)^T`` with static weight sparsity.

    Args:
      topology: ``SparseTopology`` of the weight, ``[features_out,
        features_in]``.
      use_bias: add a per-output-feature bias (initialised to 0).
      fuse_relu: apply ReLU in the SpMM epilogue.
      layout: ``"panel"``; ``"csr"`` waits for the flat op set.
      bm, bk: panel tiles (default ``panel_api.DEFAULT_BLOCK``).
      generator: ``torch.Generator`` for the Kaiming-uniform value init.
      device, dtype: where and how the parameters are created.
    """

    def __init__(self, topology: SparseTopology, *, use_bias: bool = True,
                 fuse_relu: bool = False, layout: str = "panel",
                 bm: Optional[int] = None, bk: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        if layout == "csr":
            raise NotImplementedError(
                "SparseLinear(layout='csr') needs the flat op set, not "
                "ported yet — ROADMAP A3")
        if layout != "panel":
            raise ValueError(f"unknown layout {layout!r}")
        self.topology = topology
        self.fuse_relu = fuse_relu
        self.layout = layout
        self.spec = P.PanelSpec(topology, bm, bk)
        values = P.panel_kaiming_values(topology, self.spec.bm, self.spec.bk,
                                        generator=generator, dtype=dtype)
        self.values = nn.Parameter(values.to(device))
        self.bias = (nn.Parameter(torch.zeros(topology.m, device=device,
                                              dtype=dtype))
                     if use_bias else None)

    @classmethod
    def from_mask(cls, mask: np.ndarray, **kwargs) -> "SparseLinear":
        return cls(SparseTopology.from_dense_mask(mask), **kwargs)

    @property
    def features_out(self) -> int:
        return self.topology.m

    @property
    def features_in(self) -> int:
        return self.topology.n

    def pack_dense(self, w_dense: np.ndarray) -> np.ndarray:
        """Dense ``[out, in]`` weight -> this layer's panel (host side)."""
        t = self.topology
        w_dense = np.asarray(w_dense, np.float32)
        vals = np.zeros(t.nnz_pad, np.float32)
        vals[: t.nnz] = w_dense[t.row_ids[: t.nnz], t.column_indices[: t.nnz]]
        return P.values_to_panel_np(t, vals, self.spec.bm, self.spec.bk)

    def unpack_dense(self, values_param) -> np.ndarray:
        """Panel values -> dense ``[out, in]`` weight (host side)."""
        t = self.topology
        if isinstance(values_param, torch.Tensor):
            values_param = values_param.detach().cpu().numpy()
        vals = P.panel_to_values_np(t, np.asarray(values_param, np.float32),
                                    self.spec.bm, self.spec.bk)
        out = np.zeros((t.m, t.n), np.float32)
        out[t.row_ids[: t.nnz], t.column_indices[: t.nnz]] = vals[: t.nnz]
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.topology
        if x.shape[-1] != t.n:
            raise ValueError(f"input features {x.shape[-1]} != {t.n}")
        lead = x.shape[:-1]
        xt = x.reshape(-1, t.n).T      # [in, N]: batch dims fold to columns
        if self.fuse_relu:
            b = self.bias if self.bias is not None else x.new_zeros(t.m)
            y = P.spmm_bias_relu(self.spec, self.values, xt, b)
        elif self.bias is not None:
            y = P.spmm_bias(self.spec, self.values, xt, self.bias)
        else:
            y = P.spmm(self.spec, self.values, xt)
        return y.T.reshape(*lead, t.m)
