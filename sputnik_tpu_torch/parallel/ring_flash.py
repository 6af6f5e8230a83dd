"""Ring sparse flash attention: full-causal sequence parallelism
(counterpart of ``sputnik_tpu/parallel/ring_flash.py``).

K / V stay key-sharded: on step ``t`` shard ``d`` holds key band ``(d - t)
mod ndev``, runs the ring-band flash kernel (B11a) over that band's
occupied blocks of its query shard's topology, carrying the online
softmax (unnormalised accumulator, running max and denominator) across
bands, and the band rotates one hop. The output is ``acc / max(l, 1e-30)``
after the last band.

The backward is the two-pass ring: a second pass recomputes each band's
probabilities from the forward's FINAL row statistics. With ``group == 1``
one kernel a step (B11b) advances dq and the band's dk / dv; a GQA ring
runs the two-kernel backward (B10b, then B10c, which sums the group). dk /
dv ride the ring with their band and are home after a full cycle: no psum.

The per-(shard, band) block metadata is built once on the host by slicing
each query shard's CSR to the band's key columns, so a strictly empty band
(a future band under causality) costs a launch with no tiles. The shards
are the positions of the spec's ``axis`` (default ``"sp"``) on its
``mesh``; a stacked operand holds this process's shards (all of them on
the one-device mesh, one on a rank), and every rotation is a ``ppermute``
of ``spec.comm`` over the axis, the same four a backward step on every
rank.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..ops.kernels import flash_sparse as fs
from ..ops.panel_api import work_dtype
from ..topology import SparseTopology
from .partition import RowPartition
from .sharded_ops import _bind, _here, _rows, _stack

__all__ = ["RingFlashSpec", "ring_flash_attention"]

_NEG_LARGE = -1e30
_META = ("block_cols", "nblocks", "mask_slot", "is_partial", "t_src_i",
         "t_nblocks", "t_mask_slot", "t_is_partial", "pmask")


def _slice_columns(topo: SparseTopology, windows) -> SparseTopology:
    """Host CSR column slice to one or more ``[lo, hi)`` windows, rebased
    and concatenated in window order (window ``w``'s keys land at local
    columns ``sum(len of earlier windows) + (c - lo_w)``). One window is a
    contiguous band; two are a zigzag chunk pair."""
    if not windows:
        raise ValueError("_slice_columns needs at least one [lo, hi) "
                         "window (nbands >= 1 everywhere in the ring)")
    ci = topo.column_indices[: topo.nnz]
    ri = topo.row_ids[: topo.nnz]
    bases = np.cumsum([0] + [hi - lo for lo, hi in windows])
    rows, cols, win = [], [], []
    for w, (lo, hi) in enumerate(windows):
        keep = (ci >= lo) & (ci < hi)
        rows.append(ri[keep])
        cols.append(ci[keep] - lo + bases[w])
        win.append(np.full(int(keep.sum()), w))
    rows, cols, win = (np.concatenate(x) for x in (rows, cols, win))
    order = np.lexsort((win, rows))     # stable: CSR order within a window
    offs = np.zeros(topo.m + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=topo.m), out=offs[1:])
    return SparseTopology(topo.m, int(bases[-1]), offs,
                          cols[order].astype(np.int32))


class RingFlashSpec:
    """Static bundle: a row partition and the per-(shard, band) flash
    metadata, stacked ``[ndev, nbands, ...]`` (host numpy; on a device
    through :meth:`meta`).

    Requires a natural-order (``RowPartition(balance=False)``) or zigzag
    (``RowPartition(zigzag=True)``) partition, and key padding that splits
    into bands of whole blocks (``n_pad % (ndev * bk) == 0``). The shards
    are the positions of ``axis`` on ``mesh`` (``None``: the one-device
    mesh). The CUDA kernels run ``bm = bk = 64``."""

    def __init__(self, part: RowPartition, *, bm: int = fs.KERNEL_TILE,
                 bk: int = fs.KERNEL_TILE, mesh=None, axis: str = "sp"):
        if not (np.array_equal(part.perm, np.arange(len(part.perm)))
                or part.zigzag):
            # a balanced permutation scatters query rows across shards, so
            # the band metadata would compute the wrong attention
            raise ValueError(
                "ring attention requires a natural-order partition "
                "(RowPartition(..., balance=False)) or the zigzag "
                "load-balanced one (RowPartition(..., zigzag=True) + "
                "spec.shard_queries/unshard_output)")
        _bind(self, part, mesh, axis)
        self.bm, self.bk = bm, bk
        ndev = part.ndev
        v0 = part.shards[0].block(bm, bk)
        self.mb, self.m_pad_loc = v0.mb, v0.m_pad
        self.n_pad = v0.n_pad
        if self.n_pad % (ndev * bk):
            raise ValueError(
                f"key padding n_pad={self.n_pad} must divide into "
                f"{ndev} bands of whole {bk}-blocks")
        self.n_loc = self.n_pad // ndev
        self.kb_loc = self.n_loc // bk

        # a zigzag partition zigzags the key bands too: band j is key
        # chunks j and 2*ndev-1-j, which balances the lockstep schedule
        self.kv_zigzag = part.zigzag
        if self.kv_zigzag:
            if self.n_loc % (2 * bk):
                raise ValueError(
                    f"zigzag ring needs key half-chunks of whole "
                    f"{bk}-blocks: n_pad={self.n_pad} over {ndev} "
                    f"devices gives band {self.n_loc}, not divisible "
                    f"by 2*bk={2 * bk}")
            half_k = self.n_loc // 2

            def windows(b):
                c2 = 2 * ndev - 1 - b
                return [(b * half_k, (b + 1) * half_k),
                        (c2 * half_k, (c2 + 1) * half_k)]
        else:
            def windows(b):
                return [(b * self.n_loc, (b + 1) * self.n_loc)]

        metas = [fs.build_flash_bwd_meta(
            [_slice_columns(part.shards[d], windows(b)).block(bm, bk)])
            for d in range(ndev) for b in range(ndev)]
        self.max_bpr = max(max(m["max_bpr"] for m in metas), 1)
        self.max_bpc = max(max(m["max_bpc"] for m in metas), 1)
        npart = max(max(m["pmask"].shape[1] for m in metas), 1)

        def stack(key, rows, maxlen):
            out = np.zeros((ndev * ndev, rows * maxlen), np.int32)
            for i, m in enumerate(metas):
                a = m[key][0]
                len_d = a.shape[0] // rows
                pad = np.zeros((rows, maxlen), np.int32)
                pad[:, :len_d] = a.reshape(rows, len_d)
                if 0 < len_d < maxlen and key in ("block_cols", "t_src_i",
                                                  "mask_slot",
                                                  "t_mask_slot"):
                    pad[:, len_d:] = pad[:, len_d - 1: len_d]
                out[i] = pad.reshape(-1)
            return out.reshape(ndev, ndev, rows * maxlen)

        self.block_cols = stack("block_cols", self.mb, self.max_bpr)
        self.mask_slot = stack("mask_slot", self.mb, self.max_bpr)
        self.is_partial = stack("is_partial", self.mb, self.max_bpr)
        self.nblocks = np.stack(
            [m["nblocks"][0] for m in metas]).reshape(ndev, ndev, self.mb)
        self.t_src_i = stack("t_src_i", self.kb_loc, self.max_bpc)
        self.t_mask_slot = stack("t_mask_slot", self.kb_loc, self.max_bpc)
        self.t_is_partial = stack("t_is_partial", self.kb_loc,
                                  self.max_bpc)
        self.t_nblocks = np.stack(
            [m["t_nblocks"][0] for m in metas]).reshape(ndev, ndev,
                                                        self.kb_loc)
        self.pmask = np.zeros((ndev, ndev, npart, bm, bk), np.float32)
        for i, m in enumerate(metas):
            d, b = divmod(i, ndev)
            self.pmask[d, b, : m["pmask"].shape[1]] = m["pmask"][0]
        self._meta = {}

    def meta(self, device) -> dict:
        """This process's rows of the stacked metadata as tensors on
        ``device``, built once per device; ``meta[key][d, band]`` is shard
        ``here[d]``'s table for ``band``."""
        device = torch.device(device)
        got = self._meta.get(device)
        if got is None:
            got = self._meta[device] = {
                k: torch.as_tensor(_rows(getattr(self, k), self),
                                   device=device)
                for k in _META}
        return got

    # -- boundary sharding helpers: reshapes and one flip, no gathers -------

    def _zig_shard(self, x, n_total, zig):
        """``x [R, s, hd]`` -> this process's shards ``[len(here), R,
        n_total // ndev, hd]``; zigzag gives shard ``d`` chunk ``d`` and
        its mirror ``2*ndev-1-d``."""
        ndev = self.part.ndev
        R, s, hd = x.shape
        xp = F.pad(x, (0, 0, 0, n_total - s))
        if zig:
            half = n_total // (2 * ndev)
            xc = xp.reshape(R, 2 * ndev, half, hd)
            xs = torch.cat([xc[:, :ndev], xc[:, ndev:].flip(1)], dim=2)
        else:
            xs = xp.reshape(R, ndev, n_total // ndev, hd)
        return xs.transpose(0, 1)[self.here]

    def _zig_unshard(self, x_sh, s, zig):
        ndev = self.part.ndev
        _, R, n_loc, hd = x_sh.shape
        o = x_sh.transpose(0, 1)                   # [R, ndev, n_loc, hd]
        if zig:
            half = n_loc // 2
            o = torch.cat([o[:, :, :half], o[:, :, half:].flip(1)], dim=1)
        return o.reshape(R, ndev * n_loc, hd)[:, :s]

    def shard_queries(self, q):
        """``q [R, s, hd]`` (natural row order) -> the partition's
        query-sharded layout ``[ndev, R, m_loc, hd]``: this process's
        shards (all on the one-device mesh)."""
        return self._zig_shard(q, self.part.m_loc * self.part.ndev,
                               self.part.zigzag)

    def shard_keys(self, k):
        """``k [R_kv, s, hd]`` -> key-sharded ``[ndev, R_kv, n_loc, hd]``:
        contiguous bands, or chunk-pair bands for a zigzag partition; the
        sequence is padded to ``n_pad`` first."""
        return self._zig_shard(k, self.n_pad, self.kv_zigzag)

    def unshard_output(self, out_sh, s: Optional[int] = None):
        """Inverse of :meth:`shard_queries` on every shard (the one-device
        mesh): ``[ndev, R, m_loc, hd]`` -> ``[R, s, hd]`` in natural row
        order."""
        return self._zig_unshard(
            out_sh, self.part.topo.m if s is None else s, self.part.zigzag)

    def unshard_kv(self, kv_sh, s: Optional[int] = None):
        """Inverse of :meth:`shard_keys` (for dk / dv too)."""
        return self._zig_unshard(
            kv_sh, self.part.topo.n if s is None else s, self.kv_zigzag)

    def ring_compute_balance(self) -> dict:
        """The lockstep ring's compute efficiency from the per-(shard,
        band) block counts the kernels run: step ``t`` costs the most
        blocks any shard walks in it, and ``efficiency = total / (ndev *
        wall)``."""
        ndev = self.part.ndev
        work = self.nblocks.sum(axis=2)            # [ndev, nbands]
        wall = sum(max(work[d, (d - t) % ndev] for d in range(ndev))
                   for t in range(ndev))
        total = int(work.sum())
        return {
            "total_blocks": total,
            "wall_blocks": int(wall),
            "per_device_blocks": work.sum(axis=1).tolist(),
            "efficiency": total / max(ndev * wall, 1),
        }


def _band(meta, i, band, keys):
    return [meta[k][i, band] for k in keys]


_ROWS = ("block_cols", "nblocks", "mask_slot", "is_partial", "pmask")
_COLS = ("t_src_i", "t_nblocks", "t_mask_slot", "t_is_partial", "pmask")


def _fwd_step(spec, group, meta, i, t, q, k, v, carry):
    """Step ``t`` of local position ``i`` (shard ``d = here[i]``): B11a
    advances its carry over the band it holds, ``(d - t) mod ndev``."""
    band = (spec.here[i] - t) % spec.part.ndev
    fs.flash_sparse_ring_band_fwd(*_band(meta, i, band, _ROWS), q, k, v,
                                  *carry, max_bpr=spec.max_bpr, group=group)


def _bwd_step(spec, group, meta, i, t, q, k, v, g, m, l, D, dq, dk, dv):
    """Backward step ``t`` of local position ``i``: the band's dq into
    ``dq``, its dk / dv into the rotating accumulators ``dk`` / ``dv``, in
    place."""
    band = (spec.here[i] - t) % spec.part.ndev
    if group == 1:
        fs.flash_sparse_ring_band_bwd(*_band(meta, i, band, _ROWS), q, k, v,
                                      g, m, l, D, dq, dk, dv,
                                      max_bpr=spec.max_bpr)
        return
    R = q.shape[0]
    rows = [x[None] for x in _band(meta, i, band, _ROWS)]
    cols = [x[None] for x in _band(meta, i, band, _COLS)]
    kw = dict(heads=R, scale=1.0, group=group)
    dq += fs.flash_sparse_bwd_dq(*rows, q, k, v, g, m, l, D,
                                 max_bpr=spec.max_bpr, **kw)
    dk_t, dv_t = fs.flash_sparse_bwd_dkv(*cols, q, k, v, g, m, l, D,
                                         max_bpc=spec.max_bpc, **kw)
    dk += dk_t
    dv += dv_t


class _Ring(torch.autograd.Function):
    """The ring over the stacked, padded operands: q_p ``[ndev, R,
    m_pad_loc, hd]`` (pre-scaled), k_p / v_p ``[ndev, R_kv, n_loc, hd]``.
    dq is taken with respect to the pre-scaled q_p."""

    @staticmethod
    def forward(ctx, spec, group, q_p, k_p, v_p):
        ndev, comm, ax = spec.part.ndev, spec.comm, spec.axis
        meta = spec.meta(q_p.device)
        ring = [(j, (j + 1) % ndev) for j in range(ndev)]
        qs, ks, vs = _here(q_p), _here(k_p), _here(v_p)
        carries = [(torch.zeros_like(q), q.new_full(q.shape[:2], _NEG_LARGE),
                    q.new_zeros(q.shape[:2])) for q in qs]
        for t in range(ndev):
            for i in range(len(qs)):
                _fwd_step(spec, group, meta, i, t, qs[i], ks[i], vs[i],
                          carries[i])
            ks = comm.ppermute(ks, ax, ring)
            vs = comm.ppermute(vs, ax, ring)
        out = _stack([acc / l.clamp(min=1e-30)[..., None]
                      for acc, _, l in carries])
        M = _stack([m for _, m, _ in carries])
        L = _stack([l for _, _, l in carries])
        ctx.spec, ctx.group = spec, group
        ctx.save_for_backward(q_p, k_p, v_p, out, M, L)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        spec, group = ctx.spec, ctx.group
        q_p, k_p, v_p, out, M, L = ctx.saved_tensors
        ndev, comm, ax = spec.part.ndev, spec.comm, spec.axis
        meta = spec.meta(q_p.device)
        ring = [(j, (j + 1) % ndev) for j in range(ndev)]
        g = g.contiguous()
        D = (g * out).sum(-1)                      # [ndev, R, m_pad_loc]
        qs, gs, Ms, Ls, Ds = map(_here, (q_p, g, M, L, D))
        ks, vs = _here(k_p), _here(v_p)
        dqs = [torch.zeros_like(q) for q in qs]
        dks = [torch.zeros_like(k) for k in ks]
        dvs = [torch.zeros_like(v) for v in vs]
        for t in range(ndev):
            for i in range(len(qs)):
                _bwd_step(spec, group, meta, i, t, qs[i], ks[i], vs[i],
                          gs[i], Ms[i], Ls[i], Ds[i], dqs[i], dks[i], dvs[i])
            # K / V rotate on; each band's dk / dv ride along with it, in
            # this order on every rank
            ks, vs = comm.ppermute(ks, ax, ring), comm.ppermute(vs, ax, ring)
            dks = comm.ppermute(dks, ax, ring)
            dvs = comm.ppermute(dvs, ax, ring)
        return None, None, _stack(dqs), _stack(dks), _stack(dvs)


def ring_flash_attention(spec: RingFlashSpec, q_sh, k_sh, v_sh,
                         scale=None, group: int = 1):
    """Ring sparse flash attention over the spec's shards.

    ``q_sh [ndev, R, s_loc_q, hd]`` query-sharded; ``k_sh, v_sh [ndev,
    R_kv, n_loc, hd]`` key-sharded, with ``R_kv = R // group`` (GQA).
    Returns query-sharded ``[ndev, R, s_loc_q, hd]`` in ``q_sh``'s dtype
    (computed in float32). Use for full-causal (or otherwise full-span)
    topologies."""
    R = q_sh.shape[1]
    if q_sh.shape[0] != len(spec.here):
        raise ValueError(f"q ndev {q_sh.shape[0]} != the {len(spec.here)} "
                         f"shards this process holds of the partition's "
                         f"{spec.part.ndev}")
    if group < 1 or R % group:
        raise ValueError(f"group {group} must divide replicas {R}")
    R_kv = k_sh.shape[1]
    if R_kv != R // group or v_sh.shape[1] != R_kv:
        raise ValueError(
            f"k/v replicas {R_kv}/{v_sh.shape[1]} != R // group "
            f"{R // group}")
    if k_sh.shape[2] != spec.n_loc or v_sh.shape[2] != spec.n_loc:
        # the band metadata addresses band-local key rows, so each shard
        # must carry exactly its n_loc-row band
        raise ValueError(
            f"per-device key rows {k_sh.shape[2]} != band {spec.n_loc}; "
            "pad the sequence to n_pad globally, then shard")
    hd = q_sh.shape[-1]
    scale = float(scale) if scale is not None else float(hd) ** -0.5
    w = work_dtype(q_sh.dtype)
    q_p = F.pad(q_sh.to(w) * scale,
                (0, 0, 0, spec.m_pad_loc - q_sh.shape[2])).contiguous()
    out = _Ring.apply(spec, int(group), q_p, k_sh.to(w).contiguous(),
                      v_sh.to(w).contiguous())
    return out[:, :, : q_sh.shape[2]].to(q_sh.dtype)
