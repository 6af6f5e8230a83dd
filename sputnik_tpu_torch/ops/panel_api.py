"""Panel-native ops, forward (counterpart of ``sputnik_tpu/ops/panel_api.py``).

The device layout of sparse values is the block panel
``f32[mb, max_bpr, bm, bk]`` (``blocking.BlockView``), and the ops close
over it:

  * ``spmm`` / ``spmm_bias`` / ``spmm_bias_relu``: panel x dense -> dense
    (the panel SpMM kernel and its epilogues)
  * ``sddmm``: dense x dense -> panel (the panel SDDMM kernel)
  * ``sparse_softmax``: panel -> panel (plain PyTorch, as in JAX)

Every op also takes a leading replica dimension, ``R`` panels over the one
topology (``[R, mb, max_bpr, bm, bk]`` with dense operands ``[R, n, q]``):
that is how ``SparseAttention`` runs its ``b*heads`` replicas in one launch.
CSR <-> panel conversion happens once at the boundary. Tiles are Hopper's
own (64 x 64 by default); outputs, never panel bytes, are comparable with
the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .kernels.bsr_sddmm import bsr_sddmm_panel
from .kernels.bsr_spmm import bsr_spmm_panel

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
    """Static ``(topology, bm, bk)`` bundle for panel ops.

    Holds the block metadata as device tensors, built once per device
    (``spec.meta(device)``)."""

    __slots__ = ("topo", "bm", "bk", "_view", "_meta")

    def __init__(self, topo, bm: Optional[int] = None,
                 bk: Optional[int] = None):
        self.topo = topo
        self.bm = bm or DEFAULT_BLOCK[0]
        self.bk = bk or DEFAULT_BLOCK[1]
        self._view = topo.block(self.bm, self.bk)
        self._meta = {}

    @property
    def view(self):
        return self._view

    def meta(self, device) -> dict:
        """``block_cols`` i32[mb*max_bpr], ``nblocks`` i32[mb] and the f32
        element ``mask`` [mb, max_bpr, bm, bk] on ``device``."""
        device = torch.device(device)
        got = self._meta.get(device)
        if got is None:
            bv = self._view
            got = dict(
                block_cols=torch.as_tensor(bv.block_cols.reshape(-1),
                                           device=device),
                nblocks=torch.as_tensor(bv.nblocks, device=device),
                mask=torch.as_tensor(bv.mask, dtype=torch.float32,
                                     device=device))
            self._meta[device] = got
        return got

    def __repr__(self):
        return f"PanelSpec({self.topo!r}, bm={self.bm}, bk={self.bk})"


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


def _spmm(spec, panel, dense, bias, epilogue):
    spec = _spec(spec)
    t, bv = spec.topo, spec.view
    rep = _replicated(panel)
    _check_rows("dense", dense, t.n, bv.n_pad, 3 if rep else 2)
    meta = spec.meta(panel.device)
    out = bsr_spmm_panel(
        meta["block_cols"], meta["nblocks"],
        (panel if rep else panel[None]).contiguous(),
        (dense if rep else dense[None]).contiguous(),
        bias, rows=t.m, epilogue=epilogue)
    return out if rep else out[0]


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
    meta = spec.meta(lhs.device)
    rep = rank == 3
    out = bsr_sddmm_panel(meta["block_cols"], meta["nblocks"],
                          (lhs if rep else lhs[None]).contiguous(),
                          (rhs if rep else rhs[None]).contiguous(),
                          meta["mask"])
    return out if rep else out[0]


def sparse_softmax(spec, panel):
    """Row-wise softmax over the nonzeros, panel layout in and out (with or
    without a leading replica dimension); masked slots stay exactly 0 and a
    row without nonzeros gives 0."""
    spec = _spec(spec)
    _replicated(panel)
    mask = spec.meta(panel.device)["mask"] != 0
    v = torch.where(mask, panel, _NEG_LARGE)
    row_max = v.amax(dim=(-3, -1), keepdim=True).clamp(min=_NEG_LARGE)
    e = torch.where(mask, torch.exp(v - row_max), 0.0)
    denom = e.sum(dim=(-3, -1), keepdim=True)
    return e / denom.clamp(min=torch.finfo(panel.dtype).tiny)
