"""Batched panel specs for the many-mask family: the host part of
``sputnik_tpu/ops/batched_panel.py``.

``BatchedPanelSpec`` bundles ``B`` same-shape topologies with ``heads``
replicas each (``R = B * heads``, replica ``r`` uses mask ``r // heads``)
and their stacked block metadata. The batched SpMM/SDDMM kernels of the JAX
package (``_k_spmm_bh``, ``_k_sddmm_bh``, ``_k_spmm_t_bh``) are not ported
yet (ROADMAP B6-B8); the fused attention forward reads this spec's flash
metadata (``flash_meta``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..blocking import stack_block_meta
from .kernels.flash_sparse import build_flash_meta

__all__ = ["BatchedPanelSpec"]


class BatchedPanelSpec:
    """Static bundle for ``B`` same-shape topologies x ``heads`` replicas."""

    def __init__(self, topologies: List, *, heads: int = 1, bm: int = 64,
                 bk: int = 64):
        self.topologies = list(topologies)
        self.B = len(topologies)
        self.heads = heads
        self.bm, self.bk = bm, bk
        self.views = [t.block(bm, bk) for t in topologies]
        self.meta = stack_block_meta(self.views)
        self.mb, self.kb = self.meta["mb"], self.meta["kb"]
        self.max_bpr = self.meta["max_bpr"]
        self.max_bpc = self.meta["max_bpc"]
        self.m = topologies[0].m
        self.n = topologies[0].n
        self.m_pad = self.mb * bm
        self.n_pad = self.kb * bk
        self._flash_np = None
        self._flash_dev = {}

    @classmethod
    def from_many_mask(cls, mt, *, heads: int = 1, bm: int = 64,
                       bk: int = 64) -> "BatchedPanelSpec":
        return cls(mt.topologies, heads=heads, bm=bm, bk=bk)

    @property
    def R(self) -> int:
        return self.B * self.heads

    @property
    def panel_shape(self):
        """Per-replica panel shape."""
        return (self.mb, self.max_bpr, self.bm, self.bk)

    def stack_values(self, values_r) -> np.ndarray:
        """Flat many-mask values ``[R, nnz_pad]`` -> panels ``[R, *]``
        (host-side boundary)."""
        values_r = np.asarray(values_r, np.float32)
        out = np.zeros((self.R,) + self.panel_shape, np.float32)
        for r in range(self.R):
            v = self.views[r // self.heads]
            flat = np.zeros(v.dump + 1, np.float32)
            take = min(v.scatter_idx.shape[0], values_r.shape[1])
            flat[v.scatter_idx[:take]] = values_r[r, :take]
            out[r, :, : v.max_bpr] = flat[: v.dump].reshape(v.values_shape)
        return out

    def flash_meta(self, device) -> dict:
        """``kernels.flash_sparse.build_flash_meta`` of this spec as tensors
        on ``device`` (ints stay ints): built on the host once, moved once
        per device."""
        if self._flash_np is None:
            self._flash_np = build_flash_meta(self.views)
        device = torch.device(device)
        got = self._flash_dev.get(device)
        if got is None:
            got = {k: (torch.as_tensor(v, device=device)
                       if isinstance(v, np.ndarray) else v)
                   for k, v in self._flash_np.items()}
            self._flash_dev[device] = got
        return got
