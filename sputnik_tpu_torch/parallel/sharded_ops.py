"""The sharded panel ops: a row-partitioned sparse operand against a
replicated or a row-sharded dense one (counterpart of
``sputnik_tpu/parallel/sharded_ops.py``).

Shard ``d`` owns ``RowPartition`` shard ``d`` of the sparse operand: its
panel and block metadata. The shards are the positions of the spec's
``axis`` on its ``mesh`` (a ``parallel.Mesh``; JAX's ``mesh=`` / ``axis=``,
default ``"x"``). A stacked operand's leading dim holds this process's
positions along the axis, in order (:attr:`ShardedPanelSpec.here`): all
``ndev`` on the one-device mesh (``mesh=None``), one on a rank, which builds
only its own row of the stacked metadata. Every exchange is a collective of
``spec.comm`` (:meth:`Mesh.along`) over the axis; on a mesh of more axes the
others split the operands' replica or batch dims on the caller's side.

Against a REPLICATED dense operand (every shard reads all of it):
``sharded_spmm`` (B1 a shard), ``sharded_spmm_t`` (B3 a shard, then a
``psum``), ``sharded_sddmm`` (B4 a shard), ``sharded_softmax`` (B5's
panel rows a shard) and ``sparse_attention_sharded`` (SDDMM -> softmax ->
SpMM, queries sharded, K / V replicated). Each is a
``torch.autograd.Function`` with JAX's VJP algebra: SpMM <- SDDMM + the
psum'd SpMM^T, SpMM^T <- SDDMM + SpMM, SDDMM <- SpMM + the psum'd SpMM^T,
softmax <- ``p * (g - rowsum(p * g))``. Only the transposed product
crosses shards: the psum JAX's transposition of a replicated operand
inserts, so every rank gets the replicated operand's whole cotangent,
once. On a ``ShardedCompressedSpec`` (``sharded_compressed``) the same
Functions run the compressed kernels: B13a, B13b, B14 and the softmax
B15a / B15b.

Against a ROW-SHARDED dense operand: ``sharded_spmm_halo``. Shard ``d``
owns rows ``[d * n_loc, (d + 1) * n_loc)`` of it and fetches only the rows
its block columns touch: the halo extents come from the block metadata
(:meth:`ShardedPanelSpec.halo_extents`) and arrive as sliced shifts through
``ppermute``, ``lo + hi`` rows a shard. A topology whose halo would span
the whole operand takes the dense ``all_gather`` instead. Where the halo
pays and ``n_loc`` is a whole number of blocks, the forward splits each
shard's walk (B2 twice): the interior tiles against the local shard, the
halo tiles against the halo-only buffer, summed. The exchange
(``_halo_assemble`` / ``_halo_scatter_back``) works on any ``[..., rows,
width]`` shard, which the K/V-sharded flash attention shares.

Outputs are row-sharded ``[ndev, m_pad_loc, q]`` (this process's shards)
in the partition's permuted row order. JAX pads ``q`` and ``d`` to 128
lanes, and pads a short ``lhs_sh`` / ``g_sh`` to ``m_pad_loc`` rows; this
package pads neither, as the kernels read rows past an operand's end as
zeros.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..blocking import stack_block_meta
from ..ops.kernels import bsr_compressed as _c
from ..ops.kernels.bsr_sddmm import bsr_sddmm_panel
from ..ops.kernels.bsr_spmm import bsr_spmm_panel, bsr_spmm_panel_sel
from ..ops.kernels.bsr_spmm_t import bsr_spmm_t_panel
from ..ops.panel_api import (DEFAULT_BLOCK, _promote, compressed_softmax,
                             masked_softmax, work_dtype)
from ._mesh import spec_mesh
from .partition import RowPartition

__all__ = ["ShardedPanelSpec", "sharded_spmm", "sharded_spmm_halo",
           "sharded_spmm_t", "sharded_sddmm", "sharded_softmax",
           "sparse_attention_sharded"]

_META = ("block_cols", "nblocks", "mask", "t_src_i", "t_src_s", "t_nblocks")


def _halo_extents(spec, n_loc: int) -> tuple:
    """``(lo, hi)``: the most rows any shard's block columns reach below /
    above its own ``n_loc``-row shard of the dense operand (or of K / V),
    over shards (one size for all, as the exchange's shapes are static).
    From the stacked ``block_cols`` / ``nblocks`` of a ``ShardedPanelSpec``
    or ``ShardedFlashSpec``, cached on the spec."""
    if n_loc not in spec._halo_extents:
        lo = hi = 0
        for d in range(spec.part.ndev):
            cols = spec.block_cols[d].reshape(spec.mb, spec.max_bpr)
            touched = [int(cols[i, s]) for i in range(spec.mb)
                       for s in range(int(spec.nblocks[d, i]))]
            if not touched:
                continue
            lo = max(lo, d * n_loc - min(touched) * spec.bk)
            hi = max(hi, (max(touched) + 1) * spec.bk - (d + 1) * n_loc)
        spec._halo_extents[n_loc] = (max(lo, 0), max(hi, 0))
    return spec._halo_extents[n_loc]


def _here(x) -> list:
    """This process's shards of a stacked operand, as views."""
    return list(x.unbind(0))


def _stack(xs) -> torch.Tensor:
    """Per-shard results back into one stacked tensor."""
    return torch.stack(list(xs))


def _rows(table: np.ndarray, spec) -> np.ndarray:
    """The rows of a stacked ``[ndev, ...]`` host table that this process's
    positions hold: a rank builds only its own."""
    return table[np.asarray(spec.here)]


def _bind(spec, part, mesh, axis) -> None:
    """A spec's ``part``, ``axis``, ``mesh``, ``comm`` (the mesh its
    collectives run on) and ``here`` (the global shard indices of this
    process's positions, in the order of a stacked operand's rows)."""
    spec.part, spec.axis = part, axis
    spec.mesh, spec.comm = spec_mesh(mesh, axis, part.ndev)
    spec.here = spec.comm.index(axis)


class ShardedPanelSpec:
    """Static bundle: a partition, block tiles and the stacked kernel
    metadata (host numpy for every shard; this process's rows on a device
    through :meth:`meta`). The shards are the positions of ``axis`` on
    ``mesh`` (``None``: the one-device mesh)."""

    compressed = False         # the ELL layout (``sharded_compressed``)

    def __init__(self, part: RowPartition, *, bm: int = DEFAULT_BLOCK[0],
                 bk: int = DEFAULT_BLOCK[1], mesh=None, axis: str = "x"):
        _bind(self, part, mesh, axis)
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
        """This process's rows of the stacked metadata as tensors on
        ``device``, built once per device; ``meta[key][d]`` is shard
        ``here[d]``'s."""
        device = torch.device(device)
        got = self._meta.get(device)
        if got is None:
            got = self._meta[device] = {
                k: torch.as_tensor(_rows(getattr(self, k), self),
                                   device=device)
                for k in _META}
        return got

    def halo_extents(self, n_loc: int) -> tuple:
        """``(lo, hi)``: the halo rows of an ``n_loc``-row dense shard
        (:func:`_halo_extents`)."""
        return _halo_extents(self, n_loc)


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
    """First buffer row of the slice shard ``me`` receives in a move, or
    ``None`` for a wrapped hop: an edge shard's slice from the other end of
    the mesh, which no block column reads. JAX lands it in scratch rows
    past ``n_pad``; here it is received and dropped, so it never lands in
    real rows."""
    if below:
        return (me - k) * n_loc + (n_loc - take) if me >= k else None
    return (me + k) * n_loc if me + k < spec.part.ndev else None


def _halo_assemble(spec, xs, n_loc, lo, hi, include_own=True):
    """Per shard ``x [..., n_loc, w]``, the globally indexed ``[..., n_pad,
    w]`` buffer: the shard's own rows (unless ``include_own=False``, the
    split's halo-only buffer) plus its ``lo`` / ``hi`` halo rows, received
    through sliced ``ppermute`` shifts; every other row is 0. ``xs`` are
    this process's shards."""
    ndev = spec.part.ndev
    bufs = [x.new_zeros(x.shape[:-2] + (spec.n_pad, x.shape[-1]))
            for x in xs]
    if include_own:
        for me, buf, x in zip(spec.here, bufs, xs):
            buf[..., me * n_loc: (me + 1) * n_loc, :] = x
    for k, take, below in _halo_moves(spec, n_loc, lo, hi):
        send = [x[..., n_loc - take:, :] if below else x[..., :take, :]
                for x in xs]
        shift = k if below else -k
        recv = spec.comm.ppermute(send, spec.axis, [
            (j, (j + shift) % ndev) for j in range(ndev)])
        for me, buf, r in zip(spec.here, bufs, recv):
            start = _landing(spec, n_loc, me, k, take, below)
            if start is not None:
                buf[..., start: start + take, :] = r
    return bufs


def _halo_scatter_back(spec, d_ext, n_loc, lo, hi, include_own=True):
    """The assembly's reverse: each shard's own rows of its buffer
    cotangent ``d_ext [..., n_pad, w]`` (zeros with ``include_own=False``),
    plus every halo slice's cotangent sent back to the shard it came from
    (reverse shifts) and added where the slice was cut. A dropped wrapped
    slice sends zeros back: every hop is a full cycle on every rank, forward
    and back, so no peer waits for a send that never comes."""
    ndev = spec.part.ndev
    d_loc = [e[..., me * n_loc: (me + 1) * n_loc, :].clone() if include_own
             else e.new_zeros(e.shape[:-2] + (n_loc, e.shape[-1]))
             for me, e in zip(spec.here, d_ext)]
    for k, take, below in _halo_moves(spec, n_loc, lo, hi):
        back = []
        for me, e in zip(spec.here, d_ext):
            start = _landing(spec, n_loc, me, k, take, below)
            back.append(e.new_zeros(e.shape[:-2] + (take, e.shape[-1]))
                        if start is None else e[..., start: start + take, :])
        shift = -k if below else k
        got = spec.comm.ppermute(back, spec.axis, [
            (j, (j + shift) % ndev) for j in range(ndev)])
        for x, c in zip(d_loc, got):
            if below:
                x[..., n_loc - take:, :] += c
            else:
                x[..., :take, :] += c
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
            p: {k: torch.as_tensor(_rows(st[p][k], spec), device=device)
                for k in ("cols", "sel", "nblk")} for p in ("i", "h")}
    return got


# -- per-shard kernel launches (rank-local), by the spec's layout ------------
# ``d`` is a local position: row ``d`` of ``spec.meta``, shard ``here[d]``


def _local_spmm(spec, meta, d, panel, dense):
    """Shard ``d``'s ``A_d @ dense`` (B1, compressed B13a) -> ``[m_pad_loc,
    q]``."""
    if spec.compressed:
        return _c.bsr_spmm_panel_c(
            meta["block_offsets"][d], meta["block_cols"][d], panel[None],
            dense[None], rows=spec.m_pad_loc,
            plans=meta["split_plans"][d])[0]
    return bsr_spmm_panel(meta["block_cols"][d], meta["nblocks"][d],
                          panel[None], dense[None],
                          rows=spec.m_pad_loc)[0]


def _local_spmm_t(spec, meta, d, panel, g):
    """Shard ``d``'s partial ``A_d^T @ g_d`` (B3, compressed B13b), no psum
    -> ``[n_pad, q]``."""
    if spec.compressed:
        return _c.bsr_spmm_t_panel_c(
            meta["t_gblk"][d], meta["t_rows"][d], meta["t_nblocks"][d],
            panel[None], g[None], rows=spec.n_pad)[0]
    return bsr_spmm_t_panel(meta["t_src_i"][d], meta["t_src_s"][d],
                            meta["t_nblocks"][d], panel[None], g[None],
                            rows=spec.n_pad)[0]


def _local_sddmm(spec, meta, d, lhs, rhs):
    """Shard ``d``'s sampled ``lhs_d @ rhs^T`` (B4, compressed B14) -> its
    panel, exactly 0 at masked slots (and, compressed, in the slots past
    the shard's own tiles)."""
    if spec.compressed:
        return _c.bsr_sddmm_panel_c(meta["block_rows"][d],
                                    meta["block_cols"][d], lhs[None],
                                    rhs[None], meta["mask"][d])[0]
    return bsr_sddmm_panel(meta["block_cols"][d], meta["nblocks"][d],
                           lhs[None], rhs[None], meta["mask"][d])[0]


def _local_softmax(spec, meta, d, panel):
    """Shard ``d``'s masked row softmax, differentiable: B5's panel rows
    (``panel_api.masked_softmax``, one mask, one head) or, compressed, B15a
    + B15b (``panel_api.compressed_softmax``) on the shard's metadata."""
    if spec.compressed:
        return compressed_softmax({k: v[d] for k, v in meta.items()},
                                  panel[None])[0]
    return masked_softmax(panel[None], meta["mask"][d][None],
                          meta["nblocks"][d][None], 1)[0]


def _raw_spmm(spec, panels, dense):
    """``A @ dense`` with the dense operand replicated ``[n, q]`` ->
    row-sharded ``[ndev, m_pad_loc, q]``."""
    meta = spec.meta(panels.device)
    return _stack([_local_spmm(spec, meta, d, p, dense)
                   for d, p in enumerate(_here(panels))])


def _raw_spmm_t(spec, panels, g_sh):
    """``A^T @ G`` with G row-sharded ``[ndev, m_loc, q]``: the psum of the
    shards' partial products, ``[n_pad, q]``."""
    meta = spec.meta(panels.device)
    return spec.comm.psum([_local_spmm_t(spec, meta, d, p, g)
                           for d, (p, g) in enumerate(zip(
                               _here(panels), _here(g_sh)))],
                          spec.axis)[0]


def _raw_sddmm(spec, lhs_sh, rhs):
    """``lhs`` row-sharded ``[ndev, m_loc, d]`` sampled against a replicated
    ``rhs [n, d]`` -> sharded panels ``[ndev, *panel_shape]``."""
    meta = spec.meta(lhs_sh.device)
    return _stack([_local_sddmm(spec, meta, d, x, rhs)
                   for d, x in enumerate(_here(lhs_sh))])


# -- the replicated-operand ops ----------------------------------------------


class _ShSpMM(torch.autograd.Function):
    """``A @ dense``; backward (JAX ``_sh_spmm_bwd``): d_panels = SDDMM of
    ``g`` against the dense operand, d_dense = the psum of the shards'
    SpMM^T partials."""

    @staticmethod
    def forward(ctx, spec, panels, dense):
        ctx.spec = spec
        ctx.save_for_backward(panels, dense)
        return _raw_spmm(spec, panels, dense)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        panels, dense = ctx.saved_tensors
        g, need = g.contiguous(), ctx.needs_input_grad
        d_panels = _raw_sddmm(ctx.spec, g, dense) if need[1] else None
        d_dense = (_raw_spmm_t(ctx.spec, panels, g)[: dense.shape[0]]
                   if need[2] else None)
        return None, d_panels, d_dense


class _ShSpMMT(torch.autograd.Function):
    """``A^T @ G`` -> replicated ``[n_pad, q]``; backward (JAX
    ``_sh_spmm_t_bwd``): d_panels = SDDMM(G, ct), d_G = SpMM(A, ct)."""

    @staticmethod
    def forward(ctx, spec, panels, g_sh):
        ctx.spec = spec
        ctx.save_for_backward(panels, g_sh)
        return _raw_spmm_t(spec, panels, g_sh)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        panels, g_sh = ctx.saved_tensors
        ct, need = ct.contiguous(), ctx.needs_input_grad
        d_panels = _raw_sddmm(ctx.spec, g_sh, ct) if need[1] else None
        d_g = (_raw_spmm(ctx.spec, panels, ct)[:, : g_sh.shape[1]]
               if need[2] else None)
        return None, d_panels, d_g


class _ShSDDMM(torch.autograd.Function):
    """Sampled ``lhs @ rhs^T``; backward (JAX ``_sh_sddmm_bwd``) on the
    masked panel cotangent ``gp``: d_lhs = SpMM(gp, rhs), d_rhs = the psum
    of the shards' SpMM^T(gp, lhs) partials. The output is 0 at masked
    slots whatever the inputs, so a cotangent there carries no gradient
    (the port's rule, ``panel_api``'s SDDMM); JAX feeds it through."""

    @staticmethod
    def forward(ctx, spec, lhs_sh, rhs):
        ctx.spec = spec
        ctx.save_for_backward(lhs_sh, rhs)
        return _raw_sddmm(spec, lhs_sh, rhs)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        lhs_sh, rhs = ctx.saved_tensors
        spec, need = ctx.spec, ctx.needs_input_grad
        g = torch.where(spec.meta(g.device)["mask"] != 0, g, 0.0)
        d_lhs = (_raw_spmm(spec, g, rhs)[:, : lhs_sh.shape[1]]
                 if need[1] else None)
        d_rhs = (_raw_spmm_t(spec, g, lhs_sh)[: rhs.shape[0]]
                 if need[2] else None)
        return None, d_lhs, d_rhs


def _check_panels(spec, panels):
    if (tuple(panels.shape[1:]) != spec.panel_shape
            or panels.shape[0] != len(spec.here)):
        raise ValueError(f"panels {tuple(panels.shape)} != "
                         f"[{len(spec.here)}, *{spec.panel_shape}]")


def _check_sharded(name, x, spec):
    """A row-sharded operand: ``[shards here, rows, width]`` with rows at
    most the shard's ``m_pad_loc`` (rows past it are zeros to the
    kernels)."""
    if (x.dim() != 3 or x.shape[0] != len(spec.here)
            or x.shape[1] > spec.m_pad_loc):
        raise ValueError(f"{name} {tuple(x.shape)} must be "
                         f"[{len(spec.here)}, rows <= {spec.m_pad_loc}, "
                         f"width]")


def _check_replicated(name, x, spec):
    """A replicated operand ``[n, width]``: the topology's ``n`` rows or the
    tile-padded ``n_pad`` (a wrong row count would read zeros and return
    plausible wrong numbers)."""
    if x.dim() != 2 or x.shape[0] not in (spec.part.topo.n, spec.n_pad):
        raise ValueError(f"{name} {tuple(x.shape)} must be [n, width] with "
                         f"n = {spec.part.topo.n} (or tile-padded "
                         f"{spec.n_pad})")


def sharded_spmm(spec, panels, dense):
    """Row-partitioned sparse x REPLICATED dense: ``panels [ndev,
    *spec.panel_shape]`` (``spec.stack_values``) x ``dense [n, q]`` ->
    row-sharded ``[ndev, m_pad_loc, q]`` in the partition's permuted row
    order, in the promoted dtype of the pair, computed in float32.
    Differentiable in both operands; only ``d_dense`` crosses shards (a
    psum: every rank gets the whole gradient)."""
    _check_panels(spec, panels)
    _check_replicated("dense", dense, spec)
    panels, dense, dt = _promote(panels, dense)
    return _ShSpMM.apply(spec, panels.contiguous(),
                         dense.contiguous()).to(dt)


def sharded_spmm_t(spec, panels, g_sh):
    """``A^T @ G`` with ``G`` row-sharded ``[ndev, rows <= m_pad_loc, q]``
    -> the replicated ``[n_pad, q]`` (a psum of the shards' partials).
    Differentiable in both operands."""
    _check_panels(spec, panels)
    _check_sharded("g_sh", g_sh, spec)
    panels, g_sh, dt = _promote(panels, g_sh)
    return _ShSpMMT.apply(spec, panels.contiguous(),
                          g_sh.contiguous()).to(dt)


def sharded_sddmm(spec, lhs_sh, rhs):
    """Sampled ``lhs @ rhs^T`` into the sharded panels: ``lhs_sh [ndev,
    rows <= m_pad_loc, d]`` row-sharded, ``rhs [n, d]`` replicated ->
    ``[ndev, *spec.panel_shape]``, exactly 0 at masked slots.
    Differentiable in both operands; only ``d_rhs`` crosses shards."""
    _check_sharded("lhs_sh", lhs_sh, spec)
    _check_replicated("rhs", rhs, spec)
    if lhs_sh.shape[-1] != rhs.shape[-1]:
        raise ValueError(f"lhs_sh {tuple(lhs_sh.shape)} and rhs "
                         f"{tuple(rhs.shape)} differ in depth")
    lhs_sh, rhs, dt = _promote(lhs_sh, rhs)
    return _ShSDDMM.apply(spec, lhs_sh.contiguous(),
                          rhs.contiguous()).to(dt)


def sharded_softmax(spec, panels):
    """Row softmax over each shard's nonzeros, communication-free: panels
    in and out ``[ndev, *spec.panel_shape]``, masked slots exactly 0, a row
    without nonzeros 0. One launch a shard each way (B5's panel rows;
    compressed B15a + B15b), where JAX computes it in XLA; the function is
    the same. Differentiable."""
    _check_panels(spec, panels)
    dt = panels.dtype
    panels = panels.to(work_dtype(dt))
    meta = spec.meta(panels.device)
    return _stack([_local_softmax(spec, meta, d, p) for d, p in
                   enumerate(_here(panels))]).to(dt)


def sparse_attention_sharded(spec, q, k, v, *, scale=None):
    """Sequence-sharded sparse attention: SDDMM -> softmax -> SpMM with the
    score topology row-partitioned over the shards. ``q [ndev, s_loc, d]``
    query-sharded (partition row order), ``k, v [s, d]`` replicated ->
    ``[ndev, s_loc, d]``. ``scale`` defaults to ``1 / sqrt(d)``. The
    backward's only exchanges are the psums of d_k and d_v."""
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    scores = sharded_sddmm(spec, q, k)
    w = sharded_softmax(spec, scores * scale)
    return sharded_spmm(spec, w, v)[:, : q.shape[1]]


# -- the row-sharded-operand op (halo exchange) ------------------------------


def _raw_spmm_halo(spec, panels, dense_sh):
    """The forward's three branches, per shard -> ``(out [ndev, m_pad_loc,
    q], ext)``: ``ext`` each shard's assembled ``[n_pad, q]`` rows, its own
    and its halo's, which the backward's SDDMM reads again (``None`` on the
    gathered branch)."""
    n_loc = dense_sh.shape[1]
    meta = spec.meta(panels.device)
    ps, d_loc = _here(panels), _here(dense_sh)
    plan = _halo_plan(spec, n_loc)
    if plan is not None and n_loc % spec.bk == 0:
        # the split: the interior pass reads the local shard, the halo
        # pass only the rows that arrived through the exchange
        sm = _ov_split_dev(spec, n_loc, panels.device)
        bufs = _halo_assemble(spec, d_loc, n_loc, *plan, include_own=False)
        out = []
        for d, me in enumerate(spec.here):
            ii, hh = sm["i"], sm["h"]
            out_i = bsr_spmm_panel_sel(ii["cols"][d], ii["nblk"][d],
                                       ii["sel"][d], ps[d], d_loc[d])
            out_h = bsr_spmm_panel_sel(hh["cols"][d], hh["nblk"][d],
                                       hh["sel"][d], ps[d], bufs[d])
            out.append(out_i + out_h)
            bufs[d][me * n_loc: (me + 1) * n_loc] = d_loc[d]
        return _stack(out), bufs
    if plan is None:
        ext, saved = spec.comm.all_gather(d_loc, spec.axis), None
    else:
        ext = saved = _halo_assemble(spec, d_loc, n_loc, *plan)
    return _stack([_local_spmm(spec, meta, d, p, ext[d])
                   for d, p in enumerate(ps)]), saved


class _SpMMHalo(torch.autograd.Function):
    """Forward :func:`_raw_spmm_halo`; backward (JAX ``_sh_spmm_halo_bwd``):
    without a plan, SDDMM against the gathered rows and the psum'd
    ``A^T g`` re-sharded; with one, per shard B4 on the forward's assembled
    rows, B3 without the psum, and the assembly's reverse."""

    @staticmethod
    def forward(ctx, spec, panels, dense_sh):
        out, ctx.ext = _raw_spmm_halo(spec, panels, dense_sh)
        ctx.spec = spec
        ctx.save_for_backward(panels, dense_sh)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        spec, ext = ctx.spec, ctx.ext
        panels, dense_sh = ctx.saved_tensors
        _, n_loc, q = dense_sh.shape
        ndev = spec.part.ndev
        g = g.contiguous()
        need = ctx.needs_input_grad
        if ext is None:
            d_full = spec.comm.all_gather(_here(dense_sh), spec.axis)[0]
            d_panels = _raw_sddmm(spec, g, d_full) if need[1] else None
            # the psum'd A^T g re-sharded: this process's rows
            d_dense = (_raw_spmm_t(spec, panels, g)[: ndev * n_loc]
                       .reshape(ndev, n_loc, q)[spec.here]
                       if need[2] else None)
            return None, d_panels, d_dense
        meta = spec.meta(panels.device)
        ps, gs = _here(panels), _here(g)
        d_panels = (_stack([_local_sddmm(spec, meta, d, x, ext[d])
                            for d, x in enumerate(gs)])
                    if need[1] else None)
        d_dense = None
        if need[2]:
            d_ext = [_local_spmm_t(spec, meta, d, p, gs[d])
                     for d, p in enumerate(ps)]
            d_dense = _stack(_halo_scatter_back(
                spec, d_ext, n_loc, *_halo_plan(spec, n_loc)))
        return None, d_panels, d_dense


def sharded_spmm_halo(spec: ShardedPanelSpec, panels, dense_sh):
    """Row-partitioned sparse x ROW-SHARDED dense operand.

    ``panels [ndev, mb, max_bpr, bm, bk]`` (:meth:`ShardedPanelSpec.
    stack_values`), ``dense_sh [ndev, n_loc, q]``: shard ``d``'s rows of
    the dense operand. Returns row-sharded ``[ndev, m_pad_loc, q]`` in the
    partition's permuted row order (``part.unpermute_rows`` on the
    flattened rows restores it), in the promoted dtype of the pair,
    computed in float32. Differentiable in both operands."""
    if spec.compressed:
        raise ValueError("sharded_spmm_halo runs on a ShardedPanelSpec (the "
                         "ELL layout)")
    _check_panels(spec, panels)
    if (dense_sh.dim() != 3 or dense_sh.shape[0] != len(spec.here)
            or spec.part.ndev * dense_sh.shape[1] > spec.n_pad):
        raise ValueError(f"dense_sh {tuple(dense_sh.shape)} must be "
                         f"[{len(spec.here)}, n_loc, q] with ndev * n_loc "
                         f"<= n_pad = {spec.n_pad}")
    dt = torch.promote_types(panels.dtype, dense_sh.dtype)
    w = work_dtype(dt)
    out = _SpMMHalo.apply(spec, panels.to(w).contiguous(),
                          dense_sh.to(w).contiguous())
    return out.to(dt)
