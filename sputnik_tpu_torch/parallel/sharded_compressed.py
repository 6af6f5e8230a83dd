"""The sharded COMPRESSED (true-BSR) layout: the memory-tight form of the
sharded panel ops (counterpart of ``sputnik_tpu/parallel/
sharded_compressed.py``).

``ShardedPanelSpec`` stores each shard's panel in the block-ELL layout,
every row-block padded to the global most blocks a row-block, so one dense
row inflates every shard to ``mb * max_bpr`` tiles. This spec shards the
compressed layout (``blocking.CompressedView``): each shard's panel is
``[G + 1, bm, bk]``, its occupied tiles back to back, with ``G`` the most
tiles on any shard and the last tile the dump. A shard with fewer tiles
leaves the slots past its own count empty (mask 0, exactly 0 in every
output); its transposed walk names the dump as ``G``.

The ops are the sharded panel ops of ``sharded_ops`` on this spec, which
run the compressed kernels one launch a shard: SpMM B13a, SpMM^T B13b (then
a ``psum``), SDDMM B14, and the softmax B15a + B15b with its backward on
their second modes (JAX takes the softmax in XLA with segment ops; the
function is the same). The spec takes JAX's ``mesh=`` / ``axis=`` (default
``"x"``) as ``ShardedPanelSpec`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels.bsr_compressed import SplitPlans
from ..ops.panel_api import DEFAULT_BLOCK, _view, values_to_panel_np
from .partition import RowPartition
from .sharded_ops import (_bind, _rows, sharded_sddmm, sharded_softmax,
                          sharded_spmm, sharded_spmm_t,
                          sparse_attention_sharded)

__all__ = ["ShardedCompressedSpec", "sharded_spmm_c", "sharded_spmm_t_c",
           "sharded_sddmm_c", "sharded_softmax_c",
           "sparse_attention_sharded_c"]

_META = ("block_offsets", "block_cols", "block_rows", "mask", "t_gblk",
         "t_rows", "t_nblocks")


class ShardedCompressedSpec:
    """Static bundle: a partition and the compressed block metadata stacked
    over shards at a common ``G`` (host numpy for every shard; this
    process's rows on a device through :meth:`meta`). The shards are the
    positions of ``axis`` on ``mesh`` (``None``: the one-device mesh)."""

    compressed = True

    def __init__(self, part: RowPartition, *, bm: int = DEFAULT_BLOCK[0],
                 bk: int = DEFAULT_BLOCK[1], mesh=None, axis: str = "x"):
        _bind(self, part, mesh, axis)
        self.bm, self.bk = bm, bk
        views = [_view(s, bm, bk, compressed=True) for s in part.shards]
        self.views = views
        v0 = views[0]
        self.mb, self.kb = v0.mb, v0.kb
        self.m_pad_loc, self.n_pad = v0.m_pad, v0.n_pad
        G = self.num_blocks = max(v.num_blocks for v in views)
        self.max_bpr = max(v.max_bpr for v in views)

        ndev = part.ndev
        offs = np.zeros((ndev, self.mb + 1), np.int32)
        cols = np.zeros((ndev, G + 1), np.int32)
        rows = np.zeros((ndev, G + 1), np.int32)
        mask = np.zeros((ndev, G + 1, bm, bk), np.float32)
        for d, v in enumerate(views):
            nb = v.num_blocks
            offs[d] = v.block_offsets
            cols[d, : nb + 1] = v.block_cols
            rows[d, : nb + 1] = v.block_rows
            # the empty slots repeat the dump's ids (JAX's padding)
            cols[d, nb + 1:] = v.block_cols[nb]
            rows[d, nb + 1:] = v.block_rows[nb]
            mask[d, :nb] = v.mask[:nb]
        self.block_offsets, self.block_cols = offs, cols
        self.block_rows, self.mask = rows, mask

        # the transposed walks, each shard's dump id remapped to the common G
        metas = [v.transpose_meta() for v in views]
        self.max_bpc = max(ts.shape[1] for _, ts in metas)
        tg = np.zeros((ndev, self.kb * self.max_bpc), np.int32)
        tr = np.zeros((ndev, self.kb * self.max_bpc), np.int32)
        tn = np.zeros((ndev, self.kb), np.int32)
        for d, (tnb, tsrc) in enumerate(metas):
            pad = np.zeros((self.kb, self.max_bpc, 2), np.int32)
            pad[:, :, 0] = G
            pad[:, : tsrc.shape[1]] = tsrc
            pad[:, :, 0][pad[:, :, 0] == views[d].num_blocks] = G
            for j in range(self.kb):
                nb = int(tnb[j])
                if 0 < nb < self.max_bpc:
                    pad[j, nb:] = pad[j, nb - 1]
            tg[d] = pad[:, :, 0].reshape(-1)
            tr[d] = pad[:, :, 1].reshape(-1)
            tn[d] = tnb
        self.t_gblk, self.t_rows, self.t_nblocks = tg, tr, tn
        self._meta = {}

    @property
    def panel_shape(self):
        """One shard's compressed panel shape (without the ndev axis)."""
        return (self.num_blocks + 1, self.bm, self.bk)

    def stack_values(self, values) -> np.ndarray:
        """Global CSR values -> stacked compressed panels ``[ndev, G + 1,
        bm, bk]`` (host, at the boundary). Dtype-preserving, as
        ``ShardedPanelSpec.stack_values`` (JAX's casts to float32)."""
        part, topo = self.part, self.part.topo
        ro, values = topo.row_offsets, np.asarray(values)
        out = np.zeros((part.ndev,) + self.panel_shape, values.dtype)
        for d, shard in enumerate(part.shards):
            vals = np.concatenate(
                [values[ro[r]: ro[r + 1]] for r in part._rows(d)
                 if r < topo.m] or [np.zeros(0, values.dtype)])
            v = np.zeros(shard.nnz_pad, values.dtype)
            v[: len(vals)] = vals
            p = values_to_panel_np(shard, v, self.bm, self.bk,
                                   compressed=True)
            out[d, : p.shape[0]] = p
        return out

    def meta(self, device) -> dict:
        """This process's rows of the stacked metadata as tensors on
        ``device``, built once per device (``meta[key][d]`` is shard
        ``here[d]``'s), and ``split_plans``: one ``SplitPlans`` a shard,
        from its own ``block_offsets``."""
        device = torch.device(device)
        got = self._meta.get(device)
        if got is None:
            got = self._meta[device] = {
                k: torch.as_tensor(_rows(getattr(self, k), self),
                                   device=device)
                for k in _META}
            got["split_plans"] = [SplitPlans(o, device) for o in
                                  _rows(self.block_offsets, self)]
        return got


def _check_spec(spec):
    if not isinstance(spec, ShardedCompressedSpec):
        raise TypeError(f"the _c ops take a ShardedCompressedSpec, got "
                        f"{type(spec).__name__}")


def sharded_spmm_c(spec, panels, dense):
    """``A @ dense`` row-sharded: panels ``[ndev, G + 1, bm, bk]`` x a
    replicated ``dense [n, q]`` -> ``[ndev, m_pad_loc, q]``."""
    _check_spec(spec)
    return sharded_spmm(spec, panels, dense)


def sharded_spmm_t_c(spec, panels, g_sh):
    """``A^T @ G`` with row-sharded ``G``: the replicated ``[n_pad, q]``
    psum."""
    _check_spec(spec)
    return sharded_spmm_t(spec, panels, g_sh)


def sharded_sddmm_c(spec, lhs_sh, rhs):
    """Sampled ``lhs @ rhs^T`` into the sharded compressed panels, exactly
    0 at masked slots, in the dump and in a shard's empty slots."""
    _check_spec(spec)
    return sharded_sddmm(spec, lhs_sh, rhs)


def sharded_softmax_c(spec, panels):
    """The ragged row softmax over sharded compressed panels."""
    _check_spec(spec)
    return sharded_softmax(spec, panels)


def sparse_attention_sharded_c(spec, q, k, v, *, scale=None):
    """``sparse_attention_sharded`` on the compressed layout: SDDMM ->
    ragged softmax -> SpMM, queries sharded, K / V replicated."""
    _check_spec(spec)
    return sparse_attention_sharded(spec, q, k, v, scale=scale)
