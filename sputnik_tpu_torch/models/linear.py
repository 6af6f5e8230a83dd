"""SparseLinear: a linear layer with a sparse weight matrix (counterpart of
``sputnik_tpu/models/linear.py``).

The weight ``W_sp [out, in]`` has a static ``SparseTopology``; its trainable
values live in one of two layouts:

  * ``layout="panel"`` (default): the block panel; the forward is ONE panel
    SpMM launch with every batch dim folded into the dense columns, the
    bias (and ReLU, with ``fuse_relu``) applied in the kernel's epilogue.
    The backward is one SDDMM (the values' gradient, exactly 0 at masked
    slots, so an optimizer never moves a pruned weight) and one transposed
    SpMM (the input's gradient).
  * ``layout="csr"``: the reference's flat value vector ``[nnz_pad]``,
    through the flat op set (``ops.api.left_spmm``, or ``spmm_bias_relu``
    with ``fuse_relu``); on the card the same kernels run behind a values
    -> panel scatter.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops import api, dispatch
from ..ops import panel_api as P
from ..topology import SparseTopology

__all__ = ["SparseLinear", "sparse_kaiming_values"]


def sparse_kaiming_values(topo: SparseTopology, *, gain: float = 1.0,
                          generator: Optional[torch.Generator] = None,
                          dtype=torch.float32) -> torch.Tensor:
    """Kaiming/He-uniform values over the nonzero slots of ``topo``,
    ``[nnz_pad]`` with 0 at padding, on the CPU. Scales by the effective
    fan-in (mean nonzeros per output row), so a sparse layer starts with
    its dense counterpart's output variance."""
    fan_in = max(float(topo.nnz) / max(topo.m, 1), 1.0)
    bound = gain * float(np.sqrt(3.0 / fan_in))
    vals = torch.empty(topo.nnz_pad, dtype=dtype)
    vals.uniform_(-bound, bound, generator=generator)
    return vals * torch.as_tensor(topo.valid, dtype=dtype)


class SparseLinear(nn.Module):
    """``y = act(W_sp @ x^T + b)^T`` with static weight sparsity.

    Args:
      topology: ``SparseTopology`` of the weight, ``[features_out,
        features_in]``.
      use_bias: add a per-output-feature bias (initialised to 0).
      fuse_relu: apply ReLU in the SpMM epilogue.
      layout: ``"panel"`` (block panel values) or ``"csr"`` (flat values).
      bm, bk: panel tiles (default ``panel_api.DEFAULT_BLOCK``); the csr
        layout runs the flat op set, whose tiles are the default.
      generator: ``torch.Generator`` for the Kaiming-uniform value init.
      device, dtype: where and how the parameters are created.
    """

    def __init__(self, topology: SparseTopology, *, use_bias: bool = True,
                 fuse_relu: bool = False, layout: str = "panel",
                 bm: Optional[int] = None, bk: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        if layout not in ("panel", "csr"):
            raise ValueError(f"unknown layout {layout!r}")
        if layout == "csr" and (bm or P.DEFAULT_BLOCK[0],
                                bk or P.DEFAULT_BLOCK[1]) != P.DEFAULT_BLOCK:
            raise ValueError(f"layout 'csr' runs at the flat op set's tiles "
                             f"{P.DEFAULT_BLOCK}, got bm={bm}, bk={bk}")
        self.fuse_relu = fuse_relu
        self.layout = layout
        self.topology = topology
        self.spec = (dispatch.flat_spec(topology) if layout == "csr"
                     else P.PanelSpec(topology, bm, bk))
        if layout == "panel":
            values = P.panel_kaiming_values(topology, self.spec.bm,
                                            self.spec.bk, generator=generator,
                                            dtype=dtype)
        else:
            values = sparse_kaiming_values(topology, generator=generator,
                                           dtype=dtype)
        self.values = nn.Parameter(values.to(device))
        self.bias = (nn.Parameter(torch.zeros(topology.m, device=device,
                                              dtype=dtype))
                     if use_bias else None)

    def set_topology(self, topology: SparseTopology) -> None:
        """Swap the weight's topology and its panel spec (the caller writes
        the values): the csr layout's spec is the flat op set's own
        (``dispatch.flat_spec``), the one its forward runs."""
        self.topology = topology
        self.spec = (dispatch.flat_spec(topology) if self.layout == "csr"
                     else P.PanelSpec(topology, self.spec.bm, self.spec.bk))

    @classmethod
    def from_mask(cls, mask: np.ndarray, **kwargs) -> "SparseLinear":
        return cls(SparseTopology.from_dense_mask(mask), **kwargs)

    @property
    def features_out(self) -> int:
        return self.topology.m

    @property
    def features_in(self) -> int:
        return self.topology.n

    def to_layout(self, vals: np.ndarray) -> np.ndarray:
        """CSR values ``[nnz_pad]`` -> this layer's value layout (host)."""
        if self.layout == "panel":
            return P.values_to_panel_np(self.topology, vals, self.spec.bm,
                                        self.spec.bk)
        return np.asarray(vals)

    def to_csr(self, values_param) -> np.ndarray:
        """A value-shaped array of this layer's layout -> CSR values
        ``[nnz_pad]`` (host)."""
        if isinstance(values_param, torch.Tensor):
            values_param = values_param.detach().cpu().numpy()
        if self.layout == "panel":
            return P.panel_to_values_np(self.topology, values_param,
                                        self.spec.bm, self.spec.bk)
        return np.asarray(values_param)

    def pack_dense(self, w_dense: np.ndarray) -> np.ndarray:
        """Dense ``[out, in]`` weight -> this layer's value layout (host)."""
        t = self.topology
        w_dense = np.asarray(w_dense, np.float32)
        vals = np.zeros(t.nnz_pad, np.float32)
        vals[: t.nnz] = w_dense[t.row_ids[: t.nnz], t.column_indices[: t.nnz]]
        return self.to_layout(vals)

    def unpack_dense(self, values_param) -> np.ndarray:
        """Values (this layer's layout) -> dense ``[out, in]`` (host)."""
        t = self.topology
        vals = self.to_csr(values_param).astype(np.float32)
        out = np.zeros((t.m, t.n), np.float32)
        out[t.row_ids[: t.nnz], t.column_indices[: t.nnz]] = vals[: t.nnz]
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.topology
        if x.shape[-1] != t.n:
            raise ValueError(f"input features {x.shape[-1]} != {t.n}")
        lead = x.shape[:-1]
        xt = x.reshape(-1, t.n).T      # [in, N]: batch dims fold to columns
        b = self.bias
        if self.fuse_relu and b is None:
            b = x.new_zeros(t.m)
        if self.layout == "csr":
            if self.fuse_relu:
                y = api.spmm_bias_relu(t, self.values, xt, b)
            else:
                y = api.left_spmm(t, self.values, xt)
                if b is not None:
                    y = y + b[:, None]
        elif self.fuse_relu:
            y = P.spmm_bias_relu(self.spec, self.values, xt, b)
        elif b is not None:
            y = P.spmm_bias(self.spec, self.values, xt, b)
        else:
            y = P.spmm(self.spec, self.values, xt)
        return y.T.reshape(*lead, t.m)
