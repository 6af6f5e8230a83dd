"""Compressed (true-BSR) panel kernels: the CUDA kernels' wrappers and their
plain PyTorch versions.

Replaces the five TPU kernels of ``sputnik_tpu/ops/pallas/bsr_compressed.py``:
``bsr_spmm_panel_c`` (B13a), ``bsr_spmm_t_panel_c`` (B13b),
``bsr_sddmm_panel_c`` (B14), ``c_softmax_stats`` (B15a) and
``c_softmax_apply`` (B15b). The sparse operand is the compressed panel
``[R, num_blocks + 1, bm, bk]`` (``blocking.CompressedView``): the occupied
tiles back to back, row-block ``i`` owning tiles ``block_offsets[i] ..
block_offsets[i + 1]``, the last tile a dump that every output keeps at
exactly 0. B13a, B13b and B14 are the bodies of B1, B3 and B4
(``csrc/bsr_spmm.cu``, ``bsr_spmm_t.cu``, ``bsr_sddmm.cu``) on a second
address policy; B15a and B15b are ``csrc/bsr_compressed.cu``, each with a
second mode that the softmax backward runs: ``c_softmax_rowsum`` (B15a's
walk summing ``p * g`` a row) and ``c_softmax_grad`` (B15b's pass writing
``p * (g - rs[row])``).

B13a and B15a split the serial walk of a row-block that holds many tiles:
a host plan (``split_plan``, cached per chunk size by ``SplitPlans``, which
``PanelSpec.meta(device)`` holds as ``split_plans``) cuts every row-block's
tiles into chunks, one CUDA block each (B13a at ``split_chunk(...)`` tiles,
a second launch summing the partials of the row-blocks it cut; B15a at
``softmax_chunk(...)`` tiles, the last block of a cut row-block merging
its partials in the same launch).

The plain versions take the same metadata, are vectorised over row-blocks
(block columns for the transposed product) with one step per tile slot, as
the ELL plain versions are, and run in any float dtype (float64 for
``gradcheck``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import SMS, check_operands, guard_no_grad
from ._build import check, library
from .bsr_spmm import EPILOGUES, _epilogue

__all__ = ["bsr_spmm_panel_c", "bsr_spmm_panel_c_plain", "split_chunk",
           "split_plan", "SplitPlans",
           "bsr_spmm_t_panel_c", "bsr_spmm_t_panel_c_plain",
           "bsr_sddmm_panel_c", "bsr_sddmm_panel_c_plain",
           "softmax_chunk", "c_softmax_stats", "c_softmax_stats_plain",
           "c_softmax_stats_split_plain", "c_softmax_rowsum",
           "c_softmax_rowsum_plain", "c_softmax_apply",
           "c_softmax_apply_plain", "c_softmax_grad", "c_softmax_grad_plain"]

_NEG_LARGE = -1e30     # the TPU kernel's masked score
_MIN_DENOM = 1e-30     # the TPU kernel's floor of a row's denominator
SPLIT_CTAS = 2 * SMS   # blocks B13a's first pass and B15a aim for
SOFTMAX_MAX_CHUNK = 3  # the most tiles a block of B15a walks (the
                       # sweep of chip_smoke.py's phase 2i)


def _walk(block_offsets):
    """(first tile, tile count) of every row-block, and the most tiles any
    row-block holds (the number of slot steps)."""
    offs = block_offsets.long()
    first, count = offs[:-1], offs[1:] - offs[:-1]
    steps = int(count.max().item()) if count.numel() else 0
    return first, count, steps


def split_chunk(n_tiles: int, mb: int, R: int, N: int, bm: int) -> int:
    """The most tiles one chunk of B13a's walk holds, from host ints alone
    (``n_tiles`` real tiles, ``mb`` row-blocks, ``R`` replicas, width
    ``N``, ``bm`` rows a tile). Where one block per (row-block, 64-row
    slice, 64-column tile, replica) already gives ``SPLIT_CTAS`` blocks,
    ``n_tiles``: every row-block whole, one chunk each. Else small enough
    that the chunks of the tiles reach that many blocks."""
    per_walk = R * -(-N // 64) * -(-bm // 64)
    if mb * per_walk >= SPLIT_CTAS:
        return max(n_tiles, 1)
    return max(1, -(-n_tiles // -(-SPLIT_CTAS // per_walk)))


def split_plan(block_offsets, chunk: int) -> dict:
    """B13a's split plan of ``block_offsets`` (host numpy, ``[mb + 1]``) at
    ``chunk`` tiles: row-block ``i``'s tiles ``offs[i] .. offs[i + 1] - 1``
    cut in order into chunks of at most ``chunk`` (an empty row-block keeps
    one empty chunk, which writes 0 + bias). ``chunks`` i32[n_chunks, 4]:
    row-block, first tile, tile count, partial slot (-1 for a row-block's
    only chunk, which writes its output); ``split_rows`` i32[n_split], the
    row-blocks cut in two or more, whose partial slots are
    ``split_parts[j] .. split_parts[j + 1] - 1`` (i32[n_split + 1]), in
    chunk order; ``n_parts`` the number of slots."""
    if chunk < 1:
        raise ValueError(f"chunk {chunk} < 1")
    offs = np.asarray(block_offsets, np.int64)
    count = np.diff(offs)
    n = np.maximum(1, -(-count // chunk))            # chunks a row-block
    row = np.repeat(np.arange(count.size), n)
    k = np.arange(row.size) - np.repeat(np.cumsum(n) - n, n)
    first = offs[:-1][row] + k * chunk
    cut = n[row] > 1
    part = np.full(row.size, -1)
    part[cut] = np.arange(int(cut.sum()))
    return dict(
        chunks=np.stack([row, first, np.minimum(chunk, offs[1:][row] - first),
                         part], 1).astype(np.int32),
        split_rows=np.flatnonzero(n > 1).astype(np.int32),
        split_parts=np.concatenate([[0], np.cumsum(n[n > 1])]).astype(
            np.int32),
        n_parts=int(cut.sum()))


class SplitPlans(dict):
    """The split plans (B13a, B15a) of one compressed topology on one
    device, by chunk size: each built on first use from the host's
    ``block_offsets`` (the device is never read) and kept; and B15a's merge
    counters (``merge_counters``, by replica count and stream)."""

    def __init__(self, block_offsets, device):
        super().__init__()
        self.block_offsets = np.asarray(block_offsets)
        self.device = torch.device(device)
        self.merge_counters = {}

    def counters(self, R: int) -> torch.Tensor:
        """B15a's merge counters for ``R`` replicas on the current stream,
        i32[R, mb], zero. One set a (R, stream), made on first use and left
        at zero by every launch, so launches that may overlap (two streams)
        never share a set. Under a CUDA graph's capture, a new zeroed set
        each call that only the graph holds: each replay zeroes it first,
        so a graph shares its counters with no eager call and no other
        graph."""
        shape = (R, self.block_offsets.size - 1)
        cuda = self.device.type == "cuda"
        if cuda and torch.cuda.is_current_stream_capturing():
            return torch.zeros(shape, dtype=torch.int32, device=self.device)
        key = (R, torch.cuda.current_stream(self.device).cuda_stream
               if cuda else 0)
        got = self.merge_counters.get(key)
        if got is None:
            got = self.merge_counters[key] = torch.zeros(
                shape, dtype=torch.int32, device=self.device)
        return got

    def to(self, device) -> "SplitPlans":
        device = torch.device(device)
        return self if device == self.device else SplitPlans(
            self.block_offsets, device)

    def __missing__(self, chunk):
        plan = {k: v if isinstance(v, int) else torch.as_tensor(
            v, device=self.device)
            for k, v in split_plan(self.block_offsets, chunk).items()}
        self[chunk] = plan
        return plan


def bsr_spmm_panel_c_plain(block_offsets, block_cols, panel, dense, bias=None,
                           *, rows: int, epilogue: str = "none"):
    """Plain version of B13a: one batched product per slot ``s``, row-block
    ``i`` taking tile ``block_offsets[i] + s`` while ``s`` is below its tile
    count (later slots read the dump tile and are predicated off)."""
    R, T, bm, bk = panel.shape
    K, N = dense.shape[-2:]
    kb = max(-(-K // bk), 1)
    dense_t = F.pad(dense, (0, 0, 0, kb * bk - K)).view(R, kb, bk, N)
    first, count, steps = _walk(block_offsets)
    cols = block_cols.long()
    out = panel.new_zeros((R, count.numel(), bm, N))
    for s in range(steps):
        live = s < count
        g = torch.where(live, first + s, T - 1)
        a = torch.where(live[:, None, None], panel[:, g], 0.0)
        out = out + a @ dense_t[:, cols[g]]
    return _epilogue(out.reshape(R, -1, N)[:, :rows], bias, epilogue)


def bsr_spmm_panel_c(block_offsets, block_cols, panel, dense, bias=None, *,
                     rows: int, epilogue: str = "none", plans=None):
    """``epilogue(A[r] @ dense[r] (+ bias))`` over the compressed panel.

    block_offsets i32[mb + 1], block_cols i32[T] (T = num_blocks + 1),
    panel f32[R, T, bm, bk], dense f32[R, K, N] (rows past ``K`` count as
    zero), bias f32[rows] (for ``bias`` / ``bias_relu``) -> f32[R, rows, N].
    A row-block without tiles gives exactly 0 (+ bias). ``plans``: the
    topology's ``SplitPlans`` on the panel's device
    (``PanelSpec.meta(device)["split_plans"]``); the kernel then walks the
    plan at ``split_chunk(T - 1, mb, R, N, bm)`` tiles where it cuts a
    row-block. Without it, or where the plan cuts none, one block walks
    each row-block whole. The CPU path ignores it.
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue != "none" and bias is None:
        raise ValueError(f"epilogue {epilogue!r} needs a bias")
    if panel.dim() != 4 or dense.dim() != 3:
        raise ValueError(f"panel must be rank 4 and dense rank 3, got "
                         f"{tuple(panel.shape)} and {tuple(dense.shape)}")
    R, T, bm, bk = panel.shape
    mb = block_offsets.numel() - 1
    if dense.shape[0] != R:
        raise ValueError(f"dense has {dense.shape[0]} replicas, panel {R}")
    if mb < 1 or block_cols.numel() != T:
        raise ValueError("block metadata does not match the panel shape")
    if not 0 <= rows <= mb * bm:
        raise ValueError(f"rows {rows} outside [0, {mb * bm}]")
    if not panel.is_cuda:
        return bsr_spmm_panel_c_plain(block_offsets, block_cols, panel, dense,
                                      bias, rows=rows, epilogue=epilogue)

    guard_no_grad("bsr_spmm_panel_c",
                  "panel_api.spmm / spmm_bias / spmm_bias_relu on a "
                  "compressed PanelSpec", panel, dense, bias)
    dev = panel.device
    if bias is None:
        bias = torch.zeros(rows, device=dev, dtype=torch.float32)
    check_operands("bsr_spmm_panel_c", dev,
                   block_offsets=(block_offsets, torch.int32),
                   block_cols=(block_cols, torch.int32),
                   panel=(panel, torch.float32), dense=(dense, torch.float32),
                   bias=(bias, torch.float32))
    if bias.shape != (rows,):
        raise ValueError(f"bias {tuple(bias.shape)} != ({rows},)")
    K, N = dense.shape[1:]
    plan = {}
    if plans is not None:
        if plans.block_offsets.size != mb + 1:
            raise ValueError(f"split plans of {plans.block_offsets.size - 1}"
                             f" row-blocks for a panel of {mb}")
        plan = plans[split_chunk(T - 1, mb, R, N, bm)]
    if plan.get("n_parts"):      # a row-block is cut: the split walk
        check_operands("bsr_spmm_panel_c", dev,
                       chunks=(plan["chunks"], torch.int32),
                       split_rows=(plan["split_rows"], torch.int32),
                       split_parts=(plan["split_parts"], torch.int32))
        ptrs = [plan[k].data_ptr() for k in ("chunks", "split_rows",
                                             "split_parts")]
        n_chunks, n_split = plan["chunks"].shape[0], plan["split_rows"].numel()
    else:                        # every row-block whole
        ptrs, n_chunks, n_split = [0, 0, 0], mb, 0
    if R > 65535 or n_chunks * -(-bm // 64) > 65535 or n_split > 65535:
        raise ValueError("grid too large for one launch")
    out = torch.empty((R, rows, N), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    partials = torch.empty((R, plan.get("n_parts", 0), bm, N), device=dev,
                           dtype=torch.float32)
    err = library().spmm_panel_c_f32(
        block_offsets.data_ptr(), block_cols.data_ptr(), *ptrs,
        panel.data_ptr(), dense.data_ptr(), bias.data_ptr(), out.data_ptr(),
        partials.data_ptr(), R, mb, n_chunks, n_split, plan.get("n_parts", 0),
        T, bm, bk, K, N, rows, EPILOGUES[epilogue],
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bsr_spmm_panel_c")
    bsr_spmm_panel_c.launches += 1
    return out


bsr_spmm_panel_c.launches = 0


def bsr_spmm_t_panel_c_plain(t_gblk, t_rows, t_nblocks, panel, g, *,
                             rows: int):
    """Plain version of B13b: per slot ``u``, block column ``j`` takes tile
    ``t_gblk[j, u]`` against the g rows of row-block ``t_rows[j, u]`` while
    ``u < t_nblocks[j]`` (the padded slots, which repeat the last pair, are
    predicated off)."""
    R, T, bm, bk = panel.shape
    kb = t_nblocks.numel()
    max_bpc = t_gblk.numel() // max(kb, 1)
    M, Q = g.shape[-2:]
    tr = t_rows.view(kb, max_bpc).long()
    mb = max(-(-M // bm), int(tr.max().item()) + 1 if tr.numel() else 1)
    g_t = F.pad(g, (0, 0, 0, mb * bm - M)).view(R, mb, bm, Q)
    gb = t_gblk.view(kb, max_bpc).long()
    live = (torch.arange(max_bpc, device=panel.device)[None, :]
            < t_nblocks.long()[:, None])                    # [kb, max_bpc]
    out = panel.new_zeros((R, kb, bk, Q))
    for u in range(max_bpc):
        tiles = torch.where(live[:, u, None, None], panel[:, gb[:, u]], 0.0)
        out = out + tiles.transpose(-1, -2) @ g_t[:, tr[:, u]]
    return out.reshape(R, kb * bk, Q)[:, :rows]


def bsr_spmm_t_panel_c(t_gblk, t_rows, t_nblocks, panel, g, *, rows: int):
    """``A[r]^T @ g[r]`` off the compressed panel, by global tile ids.

    t_gblk / t_rows i32[kb * max_bpc] (``CompressedView.transpose_meta``),
    t_nblocks i32[kb], panel f32[R, T, bm, bk], g f32[R, M, Q] (rows past
    ``M`` count as zero) -> f32[R, rows, Q] with ``rows <= kb * bk``. A
    block column without tiles gives exactly 0.
    """
    if panel.dim() != 4 or g.dim() != 3:
        raise ValueError(f"panel must be rank 4 and g rank 3, got "
                         f"{tuple(panel.shape)} and {tuple(g.shape)}")
    R, T, bm, bk = panel.shape
    kb = t_nblocks.numel()
    if g.shape[0] != R:
        raise ValueError(f"g has {g.shape[0]} replicas, panel {R}")
    if not 0 <= rows <= kb * bk:
        raise ValueError(f"rows {rows} outside [0, {kb * bk}]")
    if kb == 0 or t_gblk.numel() % kb or t_rows.shape != t_gblk.shape:
        raise ValueError("transposed metadata shapes disagree")
    if not panel.is_cuda:
        return bsr_spmm_t_panel_c_plain(t_gblk, t_rows, t_nblocks, panel, g,
                                        rows=rows)

    guard_no_grad("bsr_spmm_t_panel_c",
                  "panel_api.spmm_t on a compressed PanelSpec", panel, g)
    dev = panel.device
    check_operands("bsr_spmm_t_panel_c", dev,
                   t_gblk=(t_gblk, torch.int32), t_rows=(t_rows, torch.int32),
                   t_nblocks=(t_nblocks, torch.int32),
                   panel=(panel, torch.float32), g=(g, torch.float32))
    M, Q = g.shape[1:]
    if R > 65535 or kb * -(-bk // 64) > 65535:
        raise ValueError("grid too large for one launch")
    out = torch.empty((R, rows, Q), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    err = library().spmm_t_panel_c_f32(
        t_gblk.data_ptr(), t_rows.data_ptr(), t_nblocks.data_ptr(),
        panel.data_ptr(), g.data_ptr(), out.data_ptr(), R, T, kb,
        t_gblk.numel() // kb, bm, bk, M, Q, rows,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bsr_spmm_t_panel_c")
    bsr_spmm_t_panel_c.launches += 1
    return out


bsr_spmm_t_panel_c.launches = 0


def bsr_sddmm_panel_c_plain(block_rows, block_cols, lhs, rhs, mask):
    """Plain version of B14: one batched product over the real tiles, each
    sampling the lhs rows of its row-block and the rhs rows of its block
    column; masked elements and the dump tile exactly 0."""
    T, bm, bk = mask.shape
    R, M, D = lhs.shape
    Nr = rhs.shape[1]
    nblk = T - 1
    rows, cols = block_rows[:nblk].long(), block_cols[:nblk].long()
    mb = max(-(-M // bm), int(rows.max().item()) + 1 if nblk else 1)
    kb = max(-(-Nr // bk), int(cols.max().item()) + 1 if nblk else 1)
    lhs_t = F.pad(lhs, (0, 0, 0, mb * bm - M)).view(R, mb, bm, D)
    rhs_t = F.pad(rhs, (0, 0, 0, kb * bk - Nr)).view(R, kb, bk, D)
    prod = torch.einsum("rgmd,rgkd->rgmk", lhs_t[:, rows], rhs_t[:, cols])
    live = mask[:nblk]
    out = torch.where(live != 0, prod * live, 0.0)
    return torch.cat([out, out.new_zeros((R, 1, bm, bk))], dim=1)


def bsr_sddmm_panel_c(block_rows, block_cols, lhs, rhs, mask):
    """Sampled ``lhs[r] @ rhs[r]^T`` into the compressed panel.

    block_rows / block_cols i32[T] (each tile's row-block and block column,
    T = num_blocks + 1), lhs f32[R, M, D], rhs f32[R, Nr, D] (rows past
    ``M`` / ``Nr`` count as zero), mask f32[T, bm, bk] -> f32[R, T, bm, bk],
    exactly 0 at masked elements and in the dump tile ``T - 1``.
    """
    if lhs.dim() != 3 or rhs.dim() != 3 or mask.dim() != 3:
        raise ValueError("lhs and rhs must be rank 3 and mask rank 3")
    T, bm, bk = mask.shape
    R, M, D = lhs.shape
    if rhs.shape[0] != R or rhs.shape[2] != D:
        raise ValueError(f"rhs {tuple(rhs.shape)} does not match lhs "
                         f"{tuple(lhs.shape)}")
    if T < 1 or block_rows.numel() != T or block_cols.numel() != T:
        raise ValueError("block metadata does not match the mask shape")
    if not lhs.is_cuda:
        return bsr_sddmm_panel_c_plain(block_rows, block_cols, lhs, rhs, mask)

    guard_no_grad("bsr_sddmm_panel_c",
                  "panel_api.sddmm on a compressed PanelSpec", lhs, rhs)
    dev = lhs.device
    check_operands("bsr_sddmm_panel_c", dev,
                   block_rows=(block_rows, torch.int32),
                   block_cols=(block_cols, torch.int32),
                   lhs=(lhs, torch.float32), rhs=(rhs, torch.float32),
                   mask=(mask, torch.float32))
    if R > 65535 or T > 65535:
        raise ValueError("grid too large for one launch")
    out = torch.empty((R, T, bm, bk), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    err = library().sddmm_panel_c_f32(
        block_rows.data_ptr(), block_cols.data_ptr(), lhs.data_ptr(),
        rhs.data_ptr(), mask.data_ptr(), out.data_ptr(), R, T, bm, bk, M,
        rhs.shape[1], D, torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bsr_sddmm_panel_c")
    bsr_sddmm_panel_c.launches += 1
    return out


bsr_sddmm_panel_c.launches = 0


def softmax_chunk(n_tiles: int, R: int) -> int:
    """The most tiles one chunk of B15a's walk holds (``n_tiles`` real
    tiles, ``R`` replicas): few enough that the (chunk, replica) blocks
    reach ``SPLIT_CTAS`` where the tiles allow it, and never more than
    ``SOFTMAX_MAX_CHUNK``, so that no block walks a long row in series."""
    return min(SOFTMAX_MAX_CHUNK, max(1, -(-n_tiles * R // SPLIT_CTAS)))


def _vec(bk, *tensors) -> int:
    """The kernels' vector width: 16-byte loads and stores where a row of a
    tile is whole float4s and every panel is 16-byte aligned, else 4-byte
    ones."""
    return 4 if bk % 4 == 0 and all(t.data_ptr() % 16 == 0
                                    for t in tensors) else 1


def _row_walk(name, plans, dev, mb, T, R):
    """B15a's walk of ``plans`` for ``R`` replicas: (chunks, chunk size,
    partial slots, counters; the counters None where no row-block is cut,
    else held by the caller until the launch, since a set made under a
    capture has no other owner)."""
    if plans is None:
        raise ValueError(f"{name}: a CUDA panel needs plans= (PanelSpec."
                         f"meta(device)['split_plans'])")
    if plans.block_offsets.size != mb + 1:
        raise ValueError(f"split plans of {plans.block_offsets.size - 1} "
                         f"row-blocks for a panel of {mb}")
    chunk = softmax_chunk(T - 1, R)
    plan = plans[chunk]
    check_operands(name, dev, chunks=(plan["chunks"], torch.int32))
    n_parts = plan["n_parts"]
    return (plan["chunks"], chunk, n_parts,
            plans.counters(R) if n_parts else None)


def _check_softmax_panels(name, panel, mask, *more):
    if panel.dim() != 4 or mask.dim() != 3:
        raise ValueError(f"{name}: panel must be rank 4 and mask rank 3, got "
                         f"{tuple(panel.shape)} and {tuple(mask.shape)}")
    if tuple(mask.shape) != tuple(panel.shape[1:]):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} does not match "
                         f"the panel {tuple(panel.shape)}")
    for t in more:
        if t.shape != panel.shape:
            raise ValueError(f"{name}: {tuple(t.shape)} != the panel's "
                             f"{tuple(panel.shape)}")


def c_softmax_stats_plain(block_offsets, panel, mask):
    """Plain version of B15a: per slot ``s``, every row of row-block ``i``
    folds tile ``block_offsets[i] + s`` into its running max and
    denominator, online as the TPU kernel does (masked elements score
    -1e30; the denominator is rescaled by ``exp(m_prev - m_new)``)."""
    R, T, bm, bk = panel.shape
    first, count, steps = _walk(block_offsets)
    mb = count.numel()
    row_max = panel.new_full((R, mb, bm, 1), _NEG_LARGE)
    row_denom = panel.new_zeros((R, mb, bm, 1))
    for s in range(steps):
        live = s < count
        g = torch.where(live, first + s, T - 1)
        keep = mask[g] != 0                                 # [mb, bm, bk]
        v = torch.where(keep, panel[:, g], _NEG_LARGE)
        m_new = torch.maximum(row_max, v.amax(dim=-1, keepdim=True))
        p = torch.where(keep, torch.exp(v - m_new), 0.0)
        l_new = (row_denom * torch.exp(row_max - m_new)
                 + p.sum(dim=-1, keepdim=True))
        live = live[:, None, None]
        row_max = torch.where(live, m_new, row_max)
        row_denom = torch.where(live, l_new, row_denom)
    return row_max.reshape(R, mb * bm), row_denom.reshape(R, mb * bm)


def c_softmax_stats_split_plain(block_offsets, panel, mask, chunk: int):
    """B15a's split walk through plain PyTorch, the kernel's algebra: each
    chunk of ``split_plan(block_offsets, chunk)`` takes the max ``m_c`` of
    its tiles' scores (masked ones -1e30) and ``l_c = sum exp(v - m_c)``
    over its nonzeros; a row-block's chunks merge as ``m = max_c m_c`` and
    ``l = sum_c l_c exp(m_c - m)`` in chunk order. Equals the online fold
    (``c_softmax_stats_plain``) up to the order of the sums (the kernel's
    lanes fold their elements online, and it merges in another fixed
    order)."""
    R, T, bm, bk = panel.shape
    plan = split_plan(block_offsets.cpu().numpy(), chunk)
    ch = torch.as_tensor(plan["chunks"], device=panel.device).long()
    row, first, count = ch[:, 0], ch[:, 1], ch[:, 2]
    steps = max(int(count.max().item()), 1)
    live = torch.arange(steps, device=panel.device)[None] < count[:, None]
    g = torch.where(live, first[:, None] + torch.arange(
        steps, device=panel.device), T - 1)                 # [n, steps]
    keep = (mask[g] != 0) & live[..., None, None]           # [n, s, bm, bk]
    v = torch.where(keep, panel[:, g], _NEG_LARGE)          # [R, n, s, ...]
    m_c = v.amax(dim=(2, 4)).clamp(min=_NEG_LARGE)          # [R, n, bm]
    l_c = torch.where(keep, torch.exp(v - m_c[:, :, None, :, None]),
                      0.0).sum(dim=(2, 4))
    mb = block_offsets.numel() - 1
    m = panel.new_full((R, mb, bm), _NEG_LARGE).scatter_reduce_(
        1, row[None, :, None].expand_as(m_c), m_c, "amax")
    l = panel.new_zeros((R, mb, bm)).index_add_(
        1, row, l_c * torch.exp(m_c - m[:, row]))
    return m.reshape(R, mb * bm), l.reshape(R, mb * bm)


def c_softmax_stats(block_offsets, panel, mask, *, plans=None):
    """Per-row max and softmax denominator over the ragged tiles of each
    row-block: block_offsets i32[mb + 1], panel f32[R, T, bm, bk], mask
    f32[T, bm, bk] -> (row_max, row_denom) f32[R, mb * bm] each. A row
    without nonzeros gives (-1e30, 0). ``plans``: the topology's
    ``SplitPlans`` on the panel's device (``PanelSpec.meta(device)
    ["split_plans"]``); the kernel then walks the plan at
    ``softmax_chunk(T - 1, R)`` tiles a chunk and merges a cut row-block's
    chunks in the same launch, with the counters the plans hold for ``R``
    replicas and the current stream. Needed on the card; the CPU path
    ignores it."""
    _check_softmax_panels("c_softmax_stats", panel, mask)
    R, T, bm, bk = panel.shape
    mb = block_offsets.numel() - 1
    if mb < 1:
        raise ValueError("block metadata does not match the panel shape")
    if not panel.is_cuda:
        return c_softmax_stats_plain(block_offsets, panel, mask)

    guard_no_grad("c_softmax_stats",
                  "panel_api.sparse_softmax on a compressed PanelSpec", panel)
    dev = panel.device
    check_operands("c_softmax_stats", dev,
                   block_offsets=(block_offsets, torch.int32),
                   panel=(panel, torch.float32), mask=(mask, torch.float32))
    row_max = torch.empty((R, mb * bm), device=dev, dtype=torch.float32)
    row_denom = torch.empty_like(row_max)
    if row_max.numel() == 0:
        return row_max, row_denom
    chunks, chunk, n_parts, counters = _row_walk(
        "c_softmax_stats", plans, dev, mb, T, R)
    parts = torch.empty((2, R, n_parts, bm), device=dev, dtype=torch.float32)
    err = library().c_softmax_stats_f32(
        block_offsets.data_ptr(), chunks.data_ptr(), panel.data_ptr(),
        mask.data_ptr(), row_max.data_ptr(), row_denom.data_ptr(),
        parts[0].data_ptr(), parts[1].data_ptr(),
        None if counters is None else counters.data_ptr(), R, mb,
        chunks.shape[0], chunk, n_parts, T,
        bm, bk, _vec(bk, panel, mask),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "c_softmax_stats")
    c_softmax_stats.launches += 1
    return row_max, row_denom


c_softmax_stats.launches = 0


def c_softmax_rowsum_plain(block_offsets, p, g, mask):
    """Plain version of B15a's backward mode: each row's sum of ``p * g``
    over its nonzeros, ``g`` taken as 0 at masked slots and in the dump
    tile (a NaN there does not reach the sum). Tiles past the offsets' last
    (a shard's padding up to the sharded layout's common tile count) are
    not read."""
    R, T, bm, bk = p.shape
    _, count, _ = _walk(block_offsets)
    mb = count.numel()
    n = int(block_offsets[-1].item())
    tile_rows = torch.repeat_interleave(
        torch.arange(mb, device=p.device), count)           # [n]
    pg = torch.where(mask[:n] != 0, p[:, :n] * g[:, :n],
                     0.0).sum(dim=-1)                       # [R, n, bm]
    return p.new_zeros((R, mb, bm)).index_add_(1, tile_rows, pg).reshape(
        R, mb * bm)


def c_softmax_rowsum(block_offsets, p, g, mask, *, plans=None):
    """The softmax backward's ragged row sum: block_offsets i32[mb + 1], p
    (the softmax output) and g (its cotangent) f32[R, T, bm, bk], mask
    f32[T, bm, bk] -> f32[R, mb * bm], the sum of ``p * g`` over each
    row's nonzeros (masked slots and the dump tile count as 0, whatever
    ``g`` holds there). B15a's body and walk, ``plans`` as in
    ``c_softmax_stats``."""
    _check_softmax_panels("c_softmax_rowsum", p, mask, g)
    R, T, bm, bk = p.shape
    mb = block_offsets.numel() - 1
    if mb < 1:
        raise ValueError("block metadata does not match the panel shape")
    if not p.is_cuda:
        return c_softmax_rowsum_plain(block_offsets, p, g, mask)

    guard_no_grad("c_softmax_rowsum",
                  "panel_api.sparse_softmax on a compressed PanelSpec", p, g)
    dev = p.device
    check_operands("c_softmax_rowsum", dev,
                   block_offsets=(block_offsets, torch.int32),
                   p=(p, torch.float32), g=(g, torch.float32),
                   mask=(mask, torch.float32))
    rs = torch.empty((R, mb * bm), device=dev, dtype=torch.float32)
    if rs.numel() == 0:
        return rs
    chunks, chunk, n_parts, counters = _row_walk(
        "c_softmax_rowsum", plans, dev, mb, T, R)
    part = torch.empty((R, n_parts, bm), device=dev, dtype=torch.float32)
    err = library().c_softmax_rowsum_f32(
        block_offsets.data_ptr(), chunks.data_ptr(), p.data_ptr(),
        g.data_ptr(), mask.data_ptr(), rs.data_ptr(), part.data_ptr(),
        None if counters is None else counters.data_ptr(), R, mb,
        chunks.shape[0], chunk, n_parts, T, bm, bk, _vec(bk, p, g, mask),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "c_softmax_rowsum")
    c_softmax_rowsum.launches += 1
    return rs


c_softmax_rowsum.launches = 0


def _check_tile_stats(name, panel, mask, block_rows, *stats):
    R, T = panel.shape[:2]
    if block_rows.numel() != T:
        raise ValueError(f"{name}: block metadata does not match the panel "
                         f"shape")
    for s in stats:
        if s.dim() != 2 or s.shape[0] != R or s.shape != stats[0].shape:
            raise ValueError(f"{name}: row statistics "
                             f"{[tuple(x.shape) for x in stats]} do not "
                             f"match R = {R}")


def c_softmax_apply_plain(block_rows, panel, mask, row_max, row_denom):
    """Plain version of B15b: ``exp(v - m[row]) / max(l[row], 1e-30)`` where
    the mask is set, exactly 0 elsewhere and in the dump tile."""
    R, T, bm, bk = panel.shape
    rows = (block_rows.long()[:, None] * bm
            + torch.arange(bm, device=panel.device)[None, :])  # [T, bm]
    m = row_max[:, rows][..., None]
    den = row_denom[:, rows][..., None].clamp(min=_MIN_DENOM)
    keep = (mask != 0) & (torch.arange(T, device=panel.device)
                          < T - 1)[:, None, None]
    return torch.where(keep, torch.exp(panel - m) / den, 0.0)


def c_softmax_apply(block_rows, panel, mask, row_max, row_denom):
    """Normalise each tile against its row-block's statistics: block_rows
    i32[T], panel f32[R, T, bm, bk], mask f32[T, bm, bk], row_max /
    row_denom f32[R, M] (``M >= (max block_rows + 1) * bm``) ->
    f32[R, T, bm, bk], exactly 0 at masked elements and in the dump tile."""
    _check_softmax_panels("c_softmax_apply", panel, mask)
    _check_tile_stats("c_softmax_apply", panel, mask, block_rows, row_max,
                      row_denom)
    R, T, bm, bk = panel.shape
    if not panel.is_cuda:
        return c_softmax_apply_plain(block_rows, panel, mask, row_max,
                                     row_denom)

    guard_no_grad("c_softmax_apply",
                  "panel_api.sparse_softmax on a compressed PanelSpec",
                  panel, row_max, row_denom)
    dev = panel.device
    check_operands("c_softmax_apply", dev,
                   block_rows=(block_rows, torch.int32),
                   panel=(panel, torch.float32), mask=(mask, torch.float32),
                   row_max=(row_max, torch.float32),
                   row_denom=(row_denom, torch.float32))
    if R > 65535 or bm > 1024:
        raise ValueError("grid or tile too large for one launch")
    out = torch.empty_like(panel)
    if out.numel() == 0:
        return out
    err = library().c_softmax_apply_f32(
        block_rows.data_ptr(), panel.data_ptr(), mask.data_ptr(),
        row_max.data_ptr(), row_denom.data_ptr(), out.data_ptr(), R, T, bm,
        bk, row_max.shape[1], _vec(bk, panel, mask, out),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "c_softmax_apply")
    c_softmax_apply.launches += 1
    return out


c_softmax_apply.launches = 0


def c_softmax_grad_plain(block_rows, p, g, mask, rs):
    """Plain version of B15b's backward mode: ``p * (g - rs[row])`` where
    the mask is set, exactly 0 elsewhere, in the dump tile and on rows past
    ``rs``'s."""
    R, T, bm, bk = p.shape
    M = rs.shape[1]
    rows = (block_rows.long()[:, None] * bm
            + torch.arange(bm, device=p.device)[None, :])      # [T, bm]
    x = rs[:, rows.clamp(max=M - 1)][..., None]
    keep = ((mask != 0) & (torch.arange(T, device=p.device)
                           < T - 1)[:, None, None] & (rows < M)[..., None])
    return torch.where(keep, p * (g - x), 0.0)


def c_softmax_grad(block_rows, p, g, mask, rs):
    """The compressed softmax's input gradient: block_rows i32[T], p (the
    softmax output) and g (its cotangent) f32[R, T, bm, bk], mask
    f32[T, bm, bk], rs f32[R, M] (``c_softmax_rowsum``) -> f32[R, T, bm,
    bk] = ``p * (g - rs[row])`` at the nonzeros, exactly 0 at masked
    elements and in the dump tile whatever ``g`` holds there. B15b's
    body."""
    _check_softmax_panels("c_softmax_grad", p, mask, g)
    _check_tile_stats("c_softmax_grad", p, mask, block_rows, rs)
    R, T, bm, bk = p.shape
    if not p.is_cuda:
        return c_softmax_grad_plain(block_rows, p, g, mask, rs)

    guard_no_grad("c_softmax_grad",
                  "panel_api.sparse_softmax on a compressed PanelSpec",
                  p, g, rs)
    dev = p.device
    check_operands("c_softmax_grad", dev,
                   block_rows=(block_rows, torch.int32),
                   p=(p, torch.float32), g=(g, torch.float32),
                   mask=(mask, torch.float32), rs=(rs, torch.float32))
    if R > 65535 or bm > 1024:
        raise ValueError("grid or tile too large for one launch")
    out = torch.empty_like(p)
    if out.numel() == 0:
        return out
    err = library().c_softmax_grad_f32(
        block_rows.data_ptr(), p.data_ptr(), g.data_ptr(), mask.data_ptr(),
        rs.data_ptr(), out.data_ptr(), R, T, bm, bk, rs.shape[1],
        _vec(bk, p, g, mask, out),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "c_softmax_grad")
    c_softmax_grad.launches += 1
    return out


c_softmax_grad.launches = 0
