"""The halo SpMM: a row-partitioned sparse operand times a row-sharded dense
one (counterpart of ``sputnik_tpu/parallel/sharded_ops.py``'s
``sharded_spmm_halo`` and what it needs).

Shard ``d`` owns ``RowPartition`` shard ``d`` of the sparse operand (its
panel and block metadata, stacked ``[ndev, ...]``) and rows ``[d * n_loc,
(d + 1) * n_loc)`` of the dense operand. It fetches only the dense rows its
block columns touch: the halo extents come from the block metadata
(:meth:`ShardedPanelSpec.halo_extents`) and arrive as sliced shifts through
``_mesh.ppermute``, ``lo + hi`` rows a shard. A topology whose halo would
span the whole operand takes the dense ``all_gather`` instead. Where the
halo pays and ``n_loc`` is a whole number of blocks, the forward splits
each shard's walk (B2 twice): the interior tiles against the local shard,
the halo tiles against the halo-only buffer, summed.

The output is row-sharded ``[ndev, m_pad_loc, q]`` in permuted row order
(JAX pads ``q`` to 128 lanes; this package does not). The other sharded
ops (``sharded_spmm``, ``sharded_spmm_t``, ``sharded_sddmm``, ...) are
``ROADMAP.md`` A9b; ``_raw_sddmm`` and ``_raw_spmm_t`` here are their cores,
which the gathered branch's backward runs.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..blocking import stack_block_meta
from ..ops.kernels.bsr_sddmm import bsr_sddmm_panel
from ..ops.kernels.bsr_spmm import bsr_spmm_panel, bsr_spmm_panel_sel
from ..ops.kernels.bsr_spmm_t import bsr_spmm_t_panel
from ..ops.panel_api import DEFAULT_BLOCK, work_dtype
from . import _mesh
from .partition import RowPartition

__all__ = ["ShardedPanelSpec", "sharded_spmm_halo"]

_META = ("block_cols", "nblocks", "mask", "t_src_i", "t_src_s", "t_nblocks")


class ShardedPanelSpec:
    """Static bundle: a partition, block tiles and the stacked kernel
    metadata (host numpy; on a device through :meth:`meta`). ``devices``
    must be ``None``: every shard on the operands' one device (``_mesh``).
    """

    def __init__(self, part: RowPartition, *, bm: int = DEFAULT_BLOCK[0],
                 bk: int = DEFAULT_BLOCK[1], devices=None):
        _mesh.check_devices(devices)
        self.part = part
        self.bm, self.bk = bm, bk
        views = [s.block(bm, bk) for s in part.shards]
        meta = stack_block_meta(views)
        self.views = views
        self.block_cols = meta["block_cols"]     # [ndev, mb*max_bpr]
        self.nblocks = meta["nblocks"]           # [ndev, mb]
        self.max_bpr = meta["max_bpr"]
        self.mask = meta["mask"]                 # [ndev, mb, max_bpr, bm, bk]
        self.t_src_i = meta["t_src_i"]
        self.t_src_s = meta["t_src_s"]
        self.t_nblocks = meta["t_nblocks"]
        self.max_bpc = meta["max_bpc"]
        v0 = views[0]
        self.mb, self.kb = v0.mb, v0.kb
        self.m_pad_loc, self.n_pad = v0.m_pad, v0.n_pad
        self._meta = {}
        self._halo_extents = {}
        self._ov_split = {}

    @property
    def panel_shape(self):
        """One shard's panel shape (without the ndev axis)."""
        return (self.mb, self.max_bpr, self.bm, self.bk)

    def stack_values(self, values) -> np.ndarray:
        """Global CSR values -> stacked panels ``[ndev, *panel_shape]``
        (host). Dtype-preserving."""
        return self.part.stacked_panel(values, self.bm, self.bk,
                                       self.max_bpr)

    def meta(self, device) -> dict:
        """The stacked metadata as tensors on ``device``, built once per
        device; ``meta[key][d]`` is shard ``d``'s."""
        device = torch.device(device)
        got = self._meta.get(device)
        if got is None:
            got = self._meta[device] = {
                k: torch.as_tensor(getattr(self, k), device=device)
                for k in _META}
        return got

    def halo_extents(self, n_loc: int) -> tuple:
        """``(lo, hi)``: the most rows any shard's block columns reach
        below / above its own ``n_loc``-row dense shard, over shards (one
        size for all, as the exchange's shapes are static)."""
        if n_loc not in self._halo_extents:
            lo = hi = 0
            for d in range(self.part.ndev):
                cols = self.block_cols[d].reshape(self.mb, self.max_bpr)
                touched = [int(cols[i, s]) for i in range(self.mb)
                           for s in range(int(self.nblocks[d, i]))]
                if not touched:
                    continue
                lo = max(lo, d * n_loc - min(touched) * self.bk)
                hi = max(hi, (max(touched) + 1) * self.bk - (d + 1) * n_loc)
            self._halo_extents[n_loc] = (max(lo, 0), max(hi, 0))
        return self._halo_extents[n_loc]


def _halo_plan(spec, n_loc):
    """``(lo, hi)`` if the ragged exchange moves fewer rows than gathering
    every other shard, else ``None`` (the dense ``all_gather``)."""
    lo, hi = spec.halo_extents(n_loc)
    if lo + hi >= (spec.part.ndev - 1) * n_loc:
        return None
    return lo, hi


def _halo_moves(spec, n_loc, lo, hi):
    """The sliced shifts of the exchange: ``(k, take, below)`` for each hop
    ``k``; ``below`` sends a shard's bottom ``take`` rows to shard ``d +
    k`` (the receiver's lower halo), else its top rows to shard ``d -
    k``."""
    moves = []
    for k in range(1, -(-lo // n_loc) + 1):
        moves.append((k, min(n_loc, lo - (k - 1) * n_loc), True))
    for k in range(1, -(-hi // n_loc) + 1):
        moves.append((k, min(n_loc, hi - (k - 1) * n_loc), False))
    return moves


def _landing(spec, n_loc, me, k, take, below):
    """First buffer row of the slice shard ``me`` receives in a move; a
    wrapped hop lands in the scratch rows past ``n_pad``."""
    if below:
        return (me - k) * n_loc + (n_loc - take) if me >= k else spec.n_pad
    return (me + k) * n_loc if me + k < spec.part.ndev else spec.n_pad


def _halo_assemble(spec, d_loc, n_loc, lo, hi, include_own=True):
    """Per shard, the globally indexed ``[n_pad + n_loc, q]`` dense buffer:
    the shard's own rows (unless ``include_own=False``, the split's
    halo-only buffer) plus its ``lo`` / ``hi`` halo rows, received through
    sliced ``_mesh.ppermute`` shifts. The trailing ``n_loc`` scratch rows
    take the wrapped edge shards' slices, which no block column reads."""
    ndev = spec.part.ndev
    bufs = [x.new_zeros((spec.n_pad + n_loc, x.shape[-1])) for x in d_loc]
    if include_own:
        for me, (buf, x) in enumerate(zip(bufs, d_loc)):
            buf[me * n_loc: (me + 1) * n_loc] = x
    for k, take, below in _halo_moves(spec, n_loc, lo, hi):
        send = [x[n_loc - take:] if below else x[:take] for x in d_loc]
        shift = k if below else -k
        recv = _mesh.ppermute(send, [(j, (j + shift) % ndev)
                                     for j in range(ndev)])
        for me, (buf, r) in enumerate(zip(bufs, recv)):
            start = _landing(spec, n_loc, me, k, take, below)
            buf[start: start + take] = r
    return bufs


def _halo_scatter_back(spec, d_ext, n_loc, lo, hi):
    """The assembly's reverse: each shard's own rows of its buffer
    cotangent ``d_ext``, plus every halo slice's cotangent sent back to the
    shard it came from (reverse shifts) and added where the slice was cut.
    Slices land in distinct rows but for the wrapped ones, which share the
    scratch rows; those rows' cotangent is 0 (no block column reads them),
    so the forward's overwrite there needs no reverse."""
    ndev = spec.part.ndev
    d_loc = [e[me * n_loc: (me + 1) * n_loc].clone()
             for me, e in enumerate(d_ext)]
    for k, take, below in _halo_moves(spec, n_loc, lo, hi):
        back = [e[s: s + take] for e, s in zip(d_ext, (
            _landing(spec, n_loc, me, k, take, below)
            for me in range(ndev)))]
        shift = -k if below else k
        got = _mesh.ppermute(back, [(j, (j + shift) % ndev)
                                    for j in range(ndev)])
        for x, c in zip(d_loc, got):
            if below:
                x[n_loc - take:] += c
            else:
                x[:take] += c
    return d_loc


def _ov_split_meta(spec, n_loc):
    """The interior / halo split of each shard's walk (host, cached per
    ``n_loc``): ``{"i": ..., "h": ...}``, each with ``cols`` / ``sel``
    ``[ndev, mb * maxb]``, ``nblk [ndev, mb]`` and ``maxb``. Interior block
    columns are rebased to the local dense shard, halo columns stay
    global; ``sel`` is each entry's panel slot, so the values never
    move."""
    if n_loc in spec._ov_split:
        return spec._ov_split[n_loc]
    ndev = spec.part.ndev
    lob = n_loc // spec.bk
    rows_i, rows_h = [], []
    for d in range(ndev):
        cols = spec.block_cols[d].reshape(spec.mb, spec.max_bpr)
        per_i, per_h = [], []
        for i in range(spec.mb):
            ci, ch = [], []
            for s in range(int(spec.nblocks[d, i])):
                c = int(cols[i, s])
                if d * lob <= c < (d + 1) * lob:
                    ci.append((c - d * lob, s))
                else:
                    ch.append((c, s))
            per_i.append(ci)
            per_h.append(ch)
        rows_i.append(per_i)
        rows_h.append(per_h)

    def stack(rows):
        maxb = max(max(max((len(r) for r in per), default=0)
                       for per in rows), 1)
        cols = np.zeros((ndev, spec.mb, maxb), np.int32)
        sel = np.zeros((ndev, spec.mb, maxb), np.int32)
        nbl = np.zeros((ndev, spec.mb), np.int32)
        for d, per in enumerate(rows):
            for i, r in enumerate(per):
                nbl[d, i] = len(r)
                for s, (c, sl) in enumerate(r):
                    cols[d, i, s] = c
                    sel[d, i, s] = sl
                if 0 < len(r) < maxb:      # repeat-pad, as JAX's walk
                    cols[d, i, len(r):] = cols[d, i, len(r) - 1]
                    sel[d, i, len(r):] = sel[d, i, len(r) - 1]
        return {"cols": cols.reshape(ndev, -1),
                "sel": sel.reshape(ndev, -1), "nblk": nbl,
                "maxb": int(maxb)}

    out = spec._ov_split[n_loc] = {"i": stack(rows_i), "h": stack(rows_h)}
    return out


def _ov_split_dev(spec, n_loc, device):
    key = ("ov", n_loc, torch.device(device))
    got = spec._meta.get(key)
    if got is None:
        st = _ov_split_meta(spec, n_loc)
        got = spec._meta[key] = {
            p: {k: torch.as_tensor(st[p][k], device=device)
                for k in ("cols", "sel", "nblk")} for p in ("i", "h")}
    return got


# -- per-shard kernel launches (rank-local) ----------------------------------


def _local_spmm(spec, meta, d, panel, dense):
    """Shard ``d``'s ``A_d @ dense`` (B1) -> ``[m_pad_loc, q]``."""
    return bsr_spmm_panel(meta["block_cols"][d], meta["nblocks"][d],
                          panel[None], dense[None],
                          rows=spec.m_pad_loc)[0]


def _local_spmm_t(spec, meta, d, panel, g):
    """Shard ``d``'s partial ``A_d^T @ g_d`` (B3), no psum ->
    ``[n_pad, q]``."""
    return bsr_spmm_t_panel(meta["t_src_i"][d], meta["t_src_s"][d],
                            meta["t_nblocks"][d], panel[None], g[None],
                            rows=spec.n_pad)[0]


def _local_sddmm(spec, meta, d, lhs, rhs):
    """Shard ``d``'s sampled ``lhs_d @ rhs^T`` (B4) -> its panel."""
    return bsr_sddmm_panel(meta["block_cols"][d], meta["nblocks"][d],
                           lhs[None], rhs[None], meta["mask"][d])[0]


def _raw_spmm_t(spec, panels, g_sh):
    """``A^T @ G`` with G row-sharded ``[ndev, m_loc, q]``: the psum of the
    shards' partial products, ``[n_pad, q]``."""
    meta = spec.meta(panels.device)
    return _mesh.psum([_local_spmm_t(spec, meta, d, p, g)
                       for d, (p, g) in enumerate(zip(
                           _mesh.shards(panels), _mesh.shards(g_sh)))])


def _raw_sddmm(spec, lhs_sh, rhs):
    """``lhs`` row-sharded ``[ndev, m_loc, d]`` sampled against a replicated
    ``rhs [n, d]`` -> sharded panels ``[ndev, mb, max_bpr, bm, bk]``."""
    meta = spec.meta(lhs_sh.device)
    return _mesh.stack([_local_sddmm(spec, meta, d, x, rhs)
                        for d, x in enumerate(_mesh.shards(lhs_sh))])


def _raw_spmm_halo(spec, panels, dense_sh):
    """The forward's three branches, per shard -> ``[ndev, m_pad_loc,
    q]``."""
    n_loc = dense_sh.shape[1]
    meta = spec.meta(panels.device)
    ps, d_loc = _mesh.shards(panels), _mesh.shards(dense_sh)
    plan = _halo_plan(spec, n_loc)
    if plan is not None and n_loc % spec.bk == 0:
        # the split: the interior pass reads the local shard, the halo
        # pass only the rows that arrived through the exchange
        sm = _ov_split_dev(spec, n_loc, panels.device)
        bufs = _halo_assemble(spec, d_loc, n_loc, *plan, include_own=False)
        out = []
        for d in range(spec.part.ndev):
            ii, hh = sm["i"], sm["h"]
            out_i = bsr_spmm_panel_sel(ii["cols"][d], ii["nblk"][d],
                                       ii["sel"][d], ps[d], d_loc[d])
            out_h = bsr_spmm_panel_sel(hh["cols"][d], hh["nblk"][d],
                                       hh["sel"][d], ps[d],
                                       bufs[d][: spec.n_pad])
            out.append(out_i + out_h)
        return _mesh.stack(out)
    if plan is None:
        full = _mesh.all_gather(d_loc)
        ext = [full] * spec.part.ndev
    else:
        ext = [b[: spec.n_pad] for b in _halo_assemble(spec, d_loc, n_loc,
                                                      *plan)]
    return _mesh.stack([_local_spmm(spec, meta, d, ps[d], ext[d])
                        for d in range(spec.part.ndev)])


class _SpMMHalo(torch.autograd.Function):
    """Forward :func:`_raw_spmm_halo`; backward (JAX ``_sh_spmm_halo_bwd``):
    without a plan, SDDMM against the gathered rows and the psum'd
    ``A^T g`` re-sharded; with one, per shard B4 on the assembled buffer,
    B3 without the psum, and the assembly's reverse."""

    @staticmethod
    def forward(ctx, spec, panels, dense_sh):
        ctx.spec = spec
        ctx.save_for_backward(panels, dense_sh)
        return _raw_spmm_halo(spec, panels, dense_sh)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        spec = ctx.spec
        panels, dense_sh = ctx.saved_tensors
        ndev, n_loc, q = dense_sh.shape
        g = g.contiguous()
        need = ctx.needs_input_grad
        plan = _halo_plan(spec, n_loc)
        if plan is None:
            d_full = _mesh.all_gather(_mesh.shards(dense_sh))
            d_panels = _raw_sddmm(spec, g, d_full) if need[1] else None
            d_dense = (_raw_spmm_t(spec, panels, g)[: ndev * n_loc]
                       .reshape(ndev, n_loc, q) if need[2] else None)
            return None, d_panels, d_dense
        meta = spec.meta(panels.device)
        ps, gs = _mesh.shards(panels), _mesh.shards(g)
        ext = _halo_assemble(spec, _mesh.shards(dense_sh), n_loc, *plan)
        d_panels = (_mesh.stack([
            _local_sddmm(spec, meta, d, gs[d], ext[d][: spec.n_pad])
            for d in range(ndev)]) if need[1] else None)
        d_dense = None
        if need[2]:
            d_ext = [torch.cat([_local_spmm_t(spec, meta, d, ps[d], gs[d]),
                                gs[d].new_zeros((n_loc, q))])
                     for d in range(ndev)]
            d_dense = _mesh.stack(_halo_scatter_back(spec, d_ext, n_loc,
                                                     *plan))
        return None, d_panels, d_dense


def sharded_spmm_halo(spec: ShardedPanelSpec, panels, dense_sh):
    """Row-partitioned sparse x ROW-SHARDED dense operand.

    ``panels [ndev, mb, max_bpr, bm, bk]`` (:meth:`ShardedPanelSpec.
    stack_values`), ``dense_sh [ndev, n_loc, q]``: shard ``d``'s rows of
    the dense operand. Returns row-sharded ``[ndev, m_pad_loc, q]`` in the
    partition's permuted row order (``part.unpermute_rows`` on the
    flattened rows restores it), in the promoted dtype of the pair,
    computed in float32. Differentiable in both operands."""
    if panels.shape[1:] != spec.panel_shape or panels.shape[0] != \
            spec.part.ndev:
        raise ValueError(f"panels {tuple(panels.shape)} != "
                         f"[{spec.part.ndev}, *{spec.panel_shape}]")
    if (dense_sh.dim() != 3 or dense_sh.shape[0] != spec.part.ndev
            or spec.part.ndev * dense_sh.shape[1] > spec.n_pad):
        raise ValueError(f"dense_sh {tuple(dense_sh.shape)} must be "
                         f"[{spec.part.ndev}, n_loc, q] with ndev * n_loc "
                         f"<= n_pad = {spec.n_pad}")
    dt = torch.promote_types(panels.dtype, dense_sh.dtype)
    w = work_dtype(dt)
    out = _SpMMHalo.apply(spec, panels.to(w).contiguous(),
                          dense_sh.to(w).contiguous())
    return out.to(dt)
