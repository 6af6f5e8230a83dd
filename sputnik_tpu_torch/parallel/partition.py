"""Row partitioner: split one sparse topology across ``ndev`` shards
(counterpart of ``sputnik_tpu/parallel/partition.py``).

Each shard owns an equal-row-count slice of the matrix; the per-shard
metadata is stacked (``[ndev, ...]`` arrays) so one program runs every
shard. An optional row permutation flattens nnz skew across the equal
slices: the longest-first serpentine round-robin over shards (the
distributed form of Sputnik's ``diffsort`` row swizzle), or ``zigzag``,
the causal-attention balancer of the ring schedule. Outputs come back in
permuted row order and are unpermuted once at the boundary
(:meth:`RowPartition.unpermute_rows`). Host numpy, as in JAX.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..blocking import stack_block_meta
from ..ops.panel_api import DEFAULT_BLOCK, values_to_panel_np
from ..topology import SparseTopology, _round_up

__all__ = ["RowPartition"]


class RowPartition:
    """Static row partition of a topology over ``ndev`` shards.

    Attributes:
      ndev: number of shards.
      m_loc: rows per shard (``m`` padded up to a multiple of ``ndev * bm``,
        ``2 * ndev * bm`` with ``zigzag``).
      perm / inv_perm: the global row permutation applied before sharding
        (identity for ``balance=False``); ``row_of_shard[d, i] =
        perm[d * m_loc + i]``.
      shards: per-shard ``SparseTopology`` (equal ``m_loc``, one shared
        ``nnz_pad`` = the largest shard's, rounded up to 4).
    """

    def __init__(self, topo: SparseTopology, ndev: int, *,
                 balance: bool = True, bm: int = DEFAULT_BLOCK[0],
                 zigzag: bool = False):
        self.topo = topo
        self.ndev = ndev
        self.zigzag = bool(zigzag)
        if zigzag:
            balance = False            # zigzag is the ring's own balancer
            m_pad = _round_up(topo.m, 2 * ndev * bm)
        else:
            m_pad = _round_up(topo.m, ndev * bm)
        self.m_loc = m_pad // ndev

        lengths = np.zeros(m_pad, np.int64)
        lengths[: topo.m] = topo.row_lengths
        if zigzag:
            # shard d owns row chunks d and 2*ndev-1-d of 2*ndev equal
            # chunks: uniform causal work, and two contiguous runs each
            half = self.m_loc // 2
            perm = np.empty(m_pad, np.int64)
            for d in range(ndev):
                lo = d * self.m_loc
                perm[lo: lo + half] = np.arange(d * half, (d + 1) * half)
                c2 = 2 * ndev - 1 - d
                perm[lo + half: lo + self.m_loc] = np.arange(
                    c2 * half, (c2 + 1) * half)
        elif balance:
            # pass p gives shard d the (p*ndev + d)-th longest row, the
            # pick reversed on odd passes, so the totals even out
            order = np.argsort(-lengths, kind="stable")
            perm = np.empty(m_pad, np.int64)
            for p in range(self.m_loc):
                seg = order[p * ndev: (p + 1) * ndev]
                if p % 2:
                    seg = seg[::-1]
                perm[np.arange(len(seg)) * self.m_loc + p] = seg
        else:
            perm = np.arange(m_pad, dtype=np.int64)
        self.perm = perm
        self.inv_perm = np.empty(m_pad, np.int64)
        self.inv_perm[perm] = np.arange(m_pad)

        # per-shard CSR of the permuted row view
        ro, ci = topo.row_offsets, topo.column_indices
        arrays = []
        for d in range(ndev):
            rows = self._rows(d)
            offs = np.zeros(self.m_loc + 1, np.int32)
            np.cumsum(lengths[rows], out=offs[1:])
            cols = np.concatenate(
                [ci[ro[r]: ro[r + 1]] for r in rows if r < topo.m]
                or [np.zeros(0, np.int32)]).astype(np.int32)
            arrays.append((offs, cols))
        self.nnz_pad = _round_up(max(max(int(o[-1]) for o, _ in arrays), 1),
                                 4)
        self.shards: List[SparseTopology] = [
            SparseTopology(self.m_loc, topo.n, offs, cols,
                           nnz_pad=self.nnz_pad)
            for offs, cols in arrays]
        self._stacked_meta = {}

    def _rows(self, d: int) -> np.ndarray:
        """The global rows shard ``d`` owns, in its local order."""
        return self.perm[d * self.m_loc: (d + 1) * self.m_loc]

    def stacked_block_meta(self, bm: int, bk: int):
        """``(block_cols [ndev, mb*max_bpr], nblocks [ndev, mb], max_bpr,
        views)`` with one ``max_bpr`` across shards (``blocking.
        stack_block_meta`` over the shards' ``BlockView``s), cached."""
        key = (bm, bk)
        if key not in self._stacked_meta:
            views = [s.block(bm, bk) for s in self.shards]
            meta = stack_block_meta(views)
            self._stacked_meta[key] = (meta["block_cols"], meta["nblocks"],
                                       meta["max_bpr"], views)
        return self._stacked_meta[key]

    def stacked_panel(self, values: np.ndarray, bm: int, bk: int,
                      max_bpr: Optional[int] = None) -> np.ndarray:
        """Global CSR values -> stacked per-shard panels ``[ndev, mb,
        max_bpr, bm, bk]`` (host, at the boundary). Dtype-preserving."""
        topo, ro = self.topo, self.topo.row_offsets
        values = np.asarray(values)
        if max_bpr is None:
            max_bpr = self.stacked_block_meta(bm, bk)[2]
        panels = []
        for d, shard in enumerate(self.shards):
            vals = np.concatenate(
                [values[ro[r]: ro[r + 1]] for r in self._rows(d)
                 if r < topo.m] or [np.zeros(0, values.dtype)])
            v = np.zeros(shard.nnz_pad, values.dtype)
            v[: len(vals)] = vals
            p = values_to_panel_np(shard, v, bm, bk)
            pad = max_bpr - p.shape[1]
            if pad > 0:
                p = np.concatenate(
                    [p, np.zeros((p.shape[0], pad, bm, bk), p.dtype)], 1)
            panels.append(p)
        return np.stack(panels)

    def unpermute_rows(self, out: torch.Tensor) -> torch.Tensor:
        """Undo the permutation on a row-major output ``[m_pad, ...] ->
        [m, ...]``."""
        idx = torch.as_tensor(self.inv_perm[: self.topo.m],
                              device=out.device)
        return torch.index_select(out, 0, idx)
