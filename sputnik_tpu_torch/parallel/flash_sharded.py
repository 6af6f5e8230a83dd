"""Sequence-parallel fused sparse attention (counterpart of
``sputnik_tpu/parallel/flash_sharded.py``).

The score topology is row(= query)-partitioned (``RowPartition``), and
each shard runs the sparse-flash kernels over its query band's occupied key
blocks, one launch a shard: B9 forward; B10a, or B10b + B10c, backward.
The shards are the positions of the spec's ``axis`` (default ``"sp"``) on
its ``mesh``; a stacked operand holds this process's shards (all of them
on the one-device mesh, one on a rank), as in ``sharded_ops``.

* :func:`flash_attention_sharded`: K / V replicated. The forward needs no
  exchange. In the backward dk / dv, partial sums over the shared key
  axis, take one ``psum`` each: every rank gets K's and V's whole
  gradient, once.
* :func:`flash_attention_kv_sharded`: K / V key-sharded like the queries.
  Each shard fetches only the halo key rows its topology touches
  (:meth:`ShardedFlashSpec.halo_extents`, sliced shifts through
  ``ppermute``: ``sharded_ops``'s exchange on ``[R_kv, rows, hd]`` shards),
  or every row through ``all_gather`` where the halo spans the sequence.
  The backward sends the halo rows' dk / dv home by the reverse shifts
  (``psum_scatter`` after the gather): no psum. By
  default, where the halo pays and a shard's band is whole blocks, each
  shard's walk splits: interior blocks against its local K / V (no
  exchange) and halo blocks against the halo-only buffer, two B9 passes
  merged by the online-softmax rule (:func:`_ov_merge`). The backward sums
  the two passes' dq; interior dk / dv land on the local shard.

The backward takes the unsharded attention's route by its rule and
constant (``ops.fused_attention._FUSED_BWD_ACC_BYTES``), so both packages
take the same route at the same shapes. The kernels take ``q`` unscaled
with ``scale`` and return dq with respect to ``q * scale``; each Function
multiplies it by ``scale`` once. On the card the kernels run 64 x 64 tiles
and hd <= 128; the plain versions (CPU tensors) take any.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..ops import fused_attention as fa
from ..ops.kernels import flash_sparse as fs
from ..ops.panel_api import work_dtype
from ..topology import SparseTopology
from .partition import RowPartition
from .sharded_ops import (_bind, _halo_assemble, _halo_extents, _halo_plan,
                          _halo_scatter_back, _here, _stack)

__all__ = ["ShardedFlashSpec", "flash_attention_sharded",
           "flash_attention_kv_sharded"]

_ROWS = ("block_cols", "nblocks", "mask_slot", "is_partial", "pmask")
_COLS = ("t_src_i", "t_nblocks", "t_mask_slot", "t_is_partial", "pmask")
_KEYS = _ROWS[:-1] + _COLS


def _stack_fmetas(fmetas, mb, kb):
    """Per-shard ``build_flash_bwd_meta`` dicts stacked ``[ndev, ...]`` at
    one ``max_bpr`` / ``max_bpc`` (repeat-padded slots, JAX's convention):
    the spec's tables and the overlap split's interior and halo tables."""
    ndev = len(fmetas)
    max_bpr = max(max(m["max_bpr"] for m in fmetas), 1)
    max_bpc = max(max(m["max_bpc"] for m in fmetas), 1)

    def stack2(key, rows, maxlen, repeat):
        outs = []
        for m in fmetas:
            a = m[key][0]
            len_d = a.shape[0] // rows
            pad = np.zeros((rows, maxlen), a.dtype)
            pad[:, :len_d] = a.reshape(rows, len_d)
            if repeat and 0 < len_d < maxlen:
                pad[:, len_d:] = pad[:, len_d - 1: len_d]
            outs.append(pad.reshape(-1))
        return np.stack(outs)

    npart = max(max(m["pmask"].shape[1] for m in fmetas), 1)
    bm, bk = fmetas[0]["bm"], fmetas[0]["bk"]
    pmask = np.zeros((ndev, npart, bm, bk), np.float32)
    for d, m in enumerate(fmetas):
        pmask[d, : m["pmask"].shape[1]] = m["pmask"][0]
    return dict(
        block_cols=stack2("block_cols", mb, max_bpr, True),
        mask_slot=stack2("mask_slot", mb, max_bpr, True),
        is_partial=stack2("is_partial", mb, max_bpr, False),
        nblocks=np.stack([m["nblocks"][0] for m in fmetas]),
        t_src_i=stack2("t_src_i", kb, max_bpc, True),
        t_mask_slot=stack2("t_mask_slot", kb, max_bpc, True),
        t_is_partial=stack2("t_is_partial", kb, max_bpc, False),
        t_nblocks=np.stack([m["t_nblocks"][0] for m in fmetas]),
        pmask=pmask, max_bpr=int(max_bpr), max_bpc=int(max_bpc))


def _on_device(st, device, here) -> dict:
    """The rows ``here`` of stacked tables (``_stack_fmetas``) as tensors on
    ``device``, with their ``max_bpr`` / ``max_bpc``."""
    got = {k: torch.as_tensor(st[k][np.asarray(here)], device=device)
           for k in _KEYS}
    got.update(max_bpr=st["max_bpr"], max_bpc=st["max_bpc"])
    return got


class ShardedFlashSpec:
    """Static bundle: a row partition and the per-shard flash metadata,
    stacked ``[ndev, ...]`` (host numpy for every shard; this process's
    rows on a device through :meth:`meta`). Every replica shares its
    shard's topology; GQA is a call-time ``group``. The shards are the
    positions of ``axis`` on ``mesh`` (``None``: the one-device mesh). The
    CUDA kernels run ``bm = bk = 64``."""

    def __init__(self, part: RowPartition, *, bm: int = fs.KERNEL_TILE,
                 bk: int = fs.KERNEL_TILE, mesh=None, axis: str = "sp"):
        _bind(self, part, mesh, axis)
        self.bm, self.bk = bm, bk
        self.views = [s.block(bm, bk) for s in part.shards]
        v0 = self.views[0]
        self.mb, self.kb = v0.mb, v0.kb
        self.m_pad_loc, self.n_pad = v0.m_pad, v0.n_pad
        # block_cols ... pmask (the stacked tables), max_bpr, max_bpc
        vars(self).update(_stack_fmetas([fs.build_flash_bwd_meta([v])
                                         for v in self.views],
                                        self.mb, self.kb))
        self._halo_extents, self._meta, self._ov = {}, {}, None

    def halo_extents(self, n_loc: int) -> tuple:
        """``(lo, hi)``: the most KEY rows any shard's topology reaches
        below / above its own ``n_loc``-row K / V band (the ragged
        exchange's size, as ``ShardedPanelSpec.halo_extents``)."""
        return _halo_extents(self, n_loc)

    def halo_plan(self, n_loc: int):
        """``(lo, hi)`` where the ragged exchange moves fewer rows than
        gathering every other shard, else ``None`` (the ``all_gather``)."""
        return _halo_plan(self, n_loc)

    def meta(self, device) -> dict:
        """This process's rows of the stacked tables as tensors on
        ``device``, built once per device (``meta[key][d]`` is shard
        ``here[d]``'s), with ``max_bpr`` and ``max_bpc``."""
        device = torch.device(device)
        if device not in self._meta:
            self._meta[device] = _on_device(vars(self), device, self.here)
        return self._meta[device]


def _tables(t, d, keys):
    """Local position ``d``'s tables in the kernels' one-mask layout."""
    return [t[k][d][None] for k in keys]


def _fwd(t, d, q, k, v, scale, group):
    """B9 over shard ``d``'s tables -> ``(out, m, l)``."""
    return fs.flash_sparse_attention_fwd(
        *_tables(t, d, _ROWS), q, k, v, heads=q.shape[0],
        max_bpr=t["max_bpr"], scale=scale, group=group)


def _bwd(t, d, fused, q, k, v, g, m, l, D, scale, group):
    """Shard ``d``'s ``(dq, dk, dv)``: B10a, or B10b + B10c. dk / dv come
    summed over each GQA group, ``[R // group, rows, hd]``."""
    kw = dict(heads=q.shape[0], scale=scale, group=group)
    if fused:
        return fs.flash_sparse_bwd_fused(*_tables(t, d, _ROWS), q, k, v, g,
                                         m, l, D, max_bpr=t["max_bpr"], **kw)
    dq = fs.flash_sparse_bwd_dq(*_tables(t, d, _ROWS), q, k, v, g, m, l, D,
                                max_bpr=t["max_bpr"], **kw)
    dk, dv = fs.flash_sparse_bwd_dkv(*_tables(t, d, _COLS), q, k, v, g, m,
                                     l, D, max_bpc=t["max_bpc"], **kw)
    return dq, dk, dv


def _stack3(parts):
    return tuple(_stack([p[i] for p in parts]) for i in range(3))


# -- K / V replicated --------------------------------------------------------


class _FlashSharded(torch.autograd.Function):
    """``q_sh [ndev, R, s_loc, hd]`` against replicated ``k, v [R_kv,
    n_pad, hd]``; backward: each shard's dq, and the psums of the shards'
    dk / dv partials."""

    @staticmethod
    def forward(ctx, spec, scale, group, q_sh, k, v):
        t = spec.meta(q_sh.device)
        out, m, l = _stack3([_fwd(t, d, q, k, v, scale, group)
                             for d, q in enumerate(_here(q_sh))])
        ctx.spec, ctx.scale, ctx.group = spec, scale, group
        ctx.save_for_backward(q_sh, k, v, out, m, l)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        spec, scale, group = ctx.spec, ctx.scale, ctx.group
        q_sh, k, v, out, m, l = ctx.saved_tensors
        g = g.contiguous()
        D = (g * out).sum(-1)
        t = spec.meta(q_sh.device)
        fused = fa._use_fused_bwd(spec, fa._hd_pad(q_sh.shape[-1]))
        parts = [_bwd(t, d, fused, q, k, v, *x, scale, group)
                 for d, (q, *x) in enumerate(zip(*map(_here, (
                     q_sh, g, m, l, D))))]
        dq = _stack([p[0] for p in parts]) * scale
        # the replicated K / V: their cotangents summed over the axis, once
        dk, dv = (spec.comm.psum([p[i] for p in parts], spec.axis)[0]
                  for i in (1, 2))
        return None, None, None, dq, dk, dv


def _check_q(spec, q_sh, kv_replicas, group):
    if q_sh.dim() != 4 or q_sh.shape[0] != len(spec.here):
        raise ValueError(f"q_sh {tuple(q_sh.shape)} must be "
                         f"[{len(spec.here)}, R, s_loc, hd]")
    if q_sh.shape[2] > spec.m_pad_loc:
        raise ValueError(f"q_sh has {q_sh.shape[2]} rows a shard, the "
                         f"partition {spec.m_pad_loc}")
    R = q_sh.shape[1]
    if group < 1 or R % group:
        raise ValueError(f"group {group} must divide replicas {R}")
    if any(r != R // group for r in kv_replicas):
        raise ValueError(f"k/v replicas {'/'.join(map(str, kv_replicas))} "
                         f"!= R // group {R // group}")


def flash_attention_sharded(spec: ShardedFlashSpec, q_sh, k, v, scale=None,
                            group: int = 1):
    """Sequence-parallel fused sparse attention, K / V replicated.

    ``q_sh [ndev, R, s_loc, hd]`` query-sharded (partition row order),
    ``k, v [R // group, s, hd]`` replicated (GQA: query replica ``r`` reads
    KV replica ``r // group``). Returns ``[ndev, R, s_loc, hd]`` in
    ``q_sh``'s dtype, computed in float32. ``scale`` defaults to ``1 /
    sqrt(hd)``."""
    _check_q(spec, q_sh, (k.shape[0], v.shape[0]), group)
    if k.dim() != 3 or k.shape != v.shape or k.shape[1] > spec.n_pad:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} must be "
                         f"[R_kv, s <= {spec.n_pad}, hd]")
    hd = q_sh.shape[-1]
    scale = float(scale) if scale is not None else float(hd) ** -0.5
    w = work_dtype(q_sh.dtype)
    # K / V padded to n_pad keys: the dk / dv psum payload is [R_kv, n_pad,
    # hd] on every shard, as JAX's
    pad = (0, 0, 0, spec.n_pad - k.shape[1])
    out = _FlashSharded.apply(spec, scale, int(group),
                              q_sh.to(w).contiguous(),
                              F.pad(k.to(w), pad).contiguous(),
                              F.pad(v.to(w), pad).contiguous())
    return out.to(q_sh.dtype)


# -- K / V key-sharded: the halo exchange ------------------------------------


def _filter_columns(topo, lo: int, hi: int, *, inside: bool):
    """Host CSR column filter. ``inside=True``: the columns in ``[lo, hi)``,
    rebased to ``[0, hi - lo)``; ``inside=False``: the others, in global
    columns."""
    ro, ci = topo.row_offsets, topo.column_indices
    offs = np.zeros(topo.m + 1, np.int32)
    cols = []
    for r in range(topo.m):
        cc = ci[ro[r]: ro[r + 1]]
        keep = (cc >= lo) & (cc < hi)
        cc = (cc[keep] - lo) if inside else cc[~keep]
        cols.append(cc)
        offs[r + 1] = offs[r] + len(cc)
    cat = (np.concatenate(cols).astype(np.int32) if offs[-1]
           else np.zeros(0, np.int32))
    return SparseTopology(topo.m, (hi - lo) if inside else topo.n, offs, cat)


def _overlap_meta(spec: ShardedFlashSpec, n_loc: int) -> dict:
    """The interior / halo split's tables (host, built once a spec): ``"i"``
    over each shard's interior key columns, rebased to its local band (the
    kernel reads the local K / V shard), ``"h"`` over the others in global
    columns (the kernel reads the halo-only buffer)."""
    if spec._ov is not None:
        if spec._ov["n_loc"] != n_loc:
            # key sharding fixes n_loc = n_pad // ndev: another value is a
            # caller's fault, not a cache miss
            raise ValueError(f"overlap metadata built for n_loc="
                             f"{spec._ov['n_loc']}, got {n_loc}")
        return spec._ov
    fmet_i, fmet_h = [], []
    for d, shard in enumerate(spec.part.shards):
        lo, hi = d * n_loc, (d + 1) * n_loc
        for out, inside in ((fmet_i, True), (fmet_h, False)):
            topo = _filter_columns(shard, lo, hi, inside=inside)
            out.append(fs.build_flash_bwd_meta([topo.block(spec.bm,
                                                           spec.bk)]))
    kb_i = n_loc // spec.bk
    spec._ov = {"i": _stack_fmetas(fmet_i, spec.mb, kb_i),
                "h": _stack_fmetas(fmet_h, spec.mb, spec.kb),
                "kb_i": kb_i, "n_loc": n_loc}
    return spec._ov


def _ov_tables(spec, n_loc, device):
    key = ("ov", torch.device(device))
    if key not in spec._meta:
        st = _overlap_meta(spec, n_loc)
        spec._meta[key] = {p: _on_device(st[p], device, spec.here)
                           for p in ("i", "h")}
    return spec._meta[key]["i"], spec._meta[key]["h"]


def _ov_merge(out_i, m_i, l_i, out_h, m_h, l_h):
    """The online-softmax merge of two partial flash results, each
    normalised by its own denominator: the rescale factors carry the l's
    (ring_flash's cross-band rule). -> ``(out, M, L)``."""
    M = torch.maximum(m_i, m_h)
    wi, wh = torch.exp(m_i - M) * l_i, torch.exp(m_h - M) * l_h
    L = wi + wh
    s = out_i.shape[1]
    out = ((out_i * wi[:, :s, None] + out_h * wh[:, :s, None])
           / L[:, :s, None].clamp(min=1e-30))
    return out, M, L


def _kv_assemble(spec, xs, n_loc, plan):
    """Each shard's globally indexed ``[R_kv, n_pad, hd]`` K or V buffer:
    the halo exchange, or the gathered sequence where there is no plan."""
    if plan is None:
        return spec.comm.all_gather(xs, spec.axis, dim=-2)
    return _halo_assemble(spec, xs, n_loc, *plan)


def _kv_scatter_back(spec, d_bufs, n_loc, plan):
    """The reverse of :func:`_kv_assemble` on the buffers' cotangents."""
    if plan is None:
        return spec.comm.psum_scatter(d_bufs, spec.axis, dim=-2)
    return _halo_scatter_back(spec, d_bufs, n_loc, *plan)


class _FlashKV(torch.autograd.Function):
    """``q_sh [ndev, R, s_loc, hd]`` against key-sharded ``k_sh, v_sh
    [ndev, R_kv, n_loc, hd]``: the exchange inside, its reverse in the
    backward (no psum). ``split``: the interior / halo passes."""

    @staticmethod
    def forward(ctx, spec, n_loc, plan, split, scale, group, q_sh, k_sh,
                v_sh):
        qs, ks, vs = map(_here, (q_sh, k_sh, v_sh))
        if split:
            kb, vb = (_halo_assemble(spec, x, n_loc, *plan,
                                     include_own=False) for x in (ks, vs))
            ti, th = _ov_tables(spec, n_loc, q_sh.device)
            parts = [_ov_merge(*_fwd(ti, d, q, ks[d], vs[d], scale, group),
                               *_fwd(th, d, q, kb[d], vb[d], scale, group))
                     for d, q in enumerate(qs)]
        else:
            kb, vb = (_kv_assemble(spec, x, n_loc, plan) for x in (ks, vs))
            t = spec.meta(q_sh.device)
            parts = [_fwd(t, d, q, kb[d], vb[d], scale, group)
                     for d, q in enumerate(qs)]
        out, M, L = _stack3(parts)
        ctx.spec, ctx.n_loc, ctx.plan, ctx.split = spec, n_loc, plan, split
        ctx.scale, ctx.group, ctx.bufs = scale, group, (kb, vb)
        ctx.save_for_backward(q_sh, k_sh, v_sh, out, M, L)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        spec, n_loc, plan, scale = ctx.spec, ctx.n_loc, ctx.plan, ctx.scale
        q_sh, k_sh, v_sh, out, M, L = ctx.saved_tensors
        kb, vb = ctx.bufs
        g = g.contiguous()
        D = (g * out).sum(-1)
        rows = list(zip(*map(_here, (q_sh, g, M, L, D))))
        hd_pad = fa._hd_pad(q_sh.shape[-1])
        if ctx.split:
            ti, th = _ov_tables(spec, n_loc, q_sh.device)
            fused = (2 * (n_loc // spec.bk + spec.kb) * spec.bk * hd_pad * 4
                     <= fa._FUSED_BWD_ACC_BYTES)
            ks, vs = _here(k_sh), _here(v_sh)
            p_i = [_bwd(ti, d, fused, q, ks[d], vs[d], *x, scale, ctx.group)
                   for d, (q, *x) in enumerate(rows)]
            p_h = [_bwd(th, d, fused, q, kb[d], vb[d], *x, scale, ctx.group)
                   for d, (q, *x) in enumerate(rows)]
            dq = [a[0] + b[0] for a, b in zip(p_i, p_h)]
            dk, dv = ([a[i] + h for a, h in zip(p_i, _halo_scatter_back(
                spec, [b[i] for b in p_h], n_loc, *plan, include_own=False))]
                for i in (1, 2))
        else:
            t = spec.meta(q_sh.device)
            fused = fa._use_fused_bwd(spec, hd_pad)
            parts = [_bwd(t, d, fused, q, kb[d], vb[d], *x, scale, ctx.group)
                     for d, (q, *x) in enumerate(rows)]
            dq = [p[0] for p in parts]
            dk, dv = (_kv_scatter_back(spec, [p[i] for p in parts], n_loc,
                                       plan) for i in (1, 2))
        return (None,) * 6 + (_stack(dq) * scale, _stack(dk), _stack(dv))


def flash_attention_kv_sharded(spec: ShardedFlashSpec, q_sh, k_sh, v_sh,
                               scale=None, group: int = 1,
                               overlap: bool = True):
    """Sequence-parallel fused sparse attention with K / V sharded over the
    same shards as the queries: the psum-free variant.

    ``q_sh [ndev, R, s_loc_q, hd]`` query-sharded (partition row order);
    ``k_sh, v_sh [ndev, R // group, s_loc_k, hd]`` key-sharded in natural
    order (shard ``d`` owns key rows ``[d * n_loc, d * n_loc + s_loc_k)``,
    ``n_loc = n_pad // ndev``). Each shard fetches only the halo key rows
    its topology touches; a full-span topology gathers them all. Returns
    ``[ndev, R, s_loc_q, hd]`` in ``q_sh``'s dtype, computed in float32.

    Meant for banded / windowed topologies with ``RowPartition(...,
    balance=False)`` (contiguous query bands: a balanced permutation
    scatters the rows and forces the gather). ``overlap`` (default on,
    taken where the halo plan is ragged and ``n_loc`` is whole blocks):
    the interior / halo split of each shard's walk, whose interior pass
    needs no exchange."""
    ndev = spec.part.ndev
    _check_q(spec, q_sh, (k_sh.shape[1], v_sh.shape[1]), group)
    if (k_sh.dim() != 4 or k_sh.shape != v_sh.shape
            or k_sh.shape[0] != q_sh.shape[0]):
        raise ValueError("k/v must carry the ndev axis (key-sharded)")
    if spec.n_pad % ndev:
        raise ValueError(
            f"key padding n_pad={spec.n_pad} must divide over ndev="
            f"{ndev} for key sharding (pad s or change bk)")
    n_loc = spec.n_pad // ndev
    if k_sh.shape[2] > n_loc:
        raise ValueError(f"per-device key rows {k_sh.shape[2]} > {n_loc}")
    hd = q_sh.shape[-1]
    scale = float(scale) if scale is not None else float(hd) ** -0.5
    w = work_dtype(q_sh.dtype)
    pad = (0, 0, 0, n_loc - k_sh.shape[2])
    plan = spec.halo_plan(n_loc)
    split = bool(overlap) and plan is not None and n_loc % spec.bk == 0
    out = _FlashKV.apply(spec, n_loc, plan, split, scale, int(group),
                         q_sh.to(w).contiguous(),
                         F.pad(k_sh.to(w), pad).contiguous(),
                         F.pad(v_sh.to(w), pad).contiguous())
    return out.to(q_sh.dtype)
