"""Decode ops over a block KV cache (counterpart of
``sputnik_tpu/ops/decode.py``).

  * ``KVCache``: per-replica cache ``k`` / ``v`` ``[R_kv, s_max, hd]``
    (f32, bf16, or int8 with per-token dequant scales), ``kv_len``
    ``i32[R_kv]``, scales ``f32[R_kv, s_max]`` (ones for fp caches).
  * ``append_kv``: one token per replica, at a shared position (``pos=``)
    or at each replica's own ``kv_len`` through the ragged-append kernel;
    ``append_kv_seq``, ``prefill_kv``, ``insert_kv_slot``.
  * ``decode_block_table``: the sinks + block-granular window table, from
    ``kv_len``, on the device; ``table_from_topology_row``.
  * ``decode_attention``: the decode-attention kernel.

**Writes are in place.** JAX's arrays are immutable, so its appends return
new caches (the ragged kernel aliases its buffers). Here every write goes
into the cache's ``k`` / ``v`` / ``k_scale`` / ``v_scale`` tensors in
place, and the returned ``KVCache`` shares them, with a new ``kv_len``
tensor. So call sites read as in JAX (``cache = append_kv(cache, ...)``),
but the ``KVCache`` passed in sees the new bytes under its old length; a
caller that needs the old cache intact clones it first
(``KVCache.clone``). ``rollback`` is only a smaller ``kv_len``.

TPU layouts do not carry over: no 128-lane ``hd_pad`` (the cache is
``[R_kv, s_max, hd]``) and no ``[R_kv, nb_pad8, bk]`` scale view. Nothing
here synchronises the host with the device: positions stay tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .kernels.decode_attention import QPAD, decode_attention_kernel
from .kernels.ragged_append import ragged_append_kernel

__all__ = [
    "KVCache", "init_kv_cache", "pad_quantize_tokens", "append_kv",
    "append_kv_seq", "prefill_kv", "insert_kv_slot", "decode_block_table",
    "table_from_topology_row", "decode_attention", "QPAD",
]


@dataclasses.dataclass(frozen=True)
class KVCache:
    """Per-replica KV cache. ``k`` / ``v``: ``[R_kv, s_max, hd]``;
    ``kv_len``: ``i32[R_kv]`` tokens written so far; ``k_scale`` /
    ``v_scale``: per-token dequant scales ``f32[R_kv, s_max]`` (ones for
    fp caches)."""

    k: torch.Tensor
    v: torch.Tensor
    kv_len: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor

    @property
    def is_int8(self) -> bool:
        return self.k.dtype == torch.int8

    @property
    def s_max(self) -> int:
        return self.k.shape[1]

    def clone(self) -> "KVCache":
        """A copy whose buffers later in-place writes do not touch."""
        return KVCache(*(t.clone() for t in dataclasses.astuple(self)))

    def with_len(self, kv_len) -> "KVCache":
        return dataclasses.replace(self, kv_len=kv_len)


def init_kv_cache(R_kv: int, s_max: int, hd: int, dtype=torch.bfloat16,
                  device=None) -> KVCache:
    """Empty cache (zeros, unit scales, ``kv_len`` 0)."""
    shape = (R_kv, s_max, hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        kv_len=torch.zeros((R_kv,), dtype=torch.int32, device=device),
        k_scale=torch.ones((R_kv, s_max), device=device),
        v_scale=torch.ones((R_kv, s_max), device=device))


def _quantize(x):
    """``f32[..., hd]`` -> ``(int8[..., hd], scale f32[...])``: symmetric
    per-token scale ``max(max|x|, 1e-30) / 127``, round half to even, clip
    to +-127."""
    scale = x.abs().amax(-1).clamp(min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def pad_quantize_tokens(k_new, v_new, dtype):
    """``(..., hd)`` K/V tokens -> the cache ``dtype`` plus per-token scales
    ``(...,)`` (ones for fp caches): the ONE definition of the cache-write
    rule, shared by every append and prefill path."""
    kf, vf = k_new.float(), v_new.float()
    if dtype == torch.int8:
        kq, ks = _quantize(kf)
        vq, vs = _quantize(vf)
        return kq, vq, ks, vs
    ones = torch.ones(kf.shape[:-1], device=kf.device)
    return kf.to(dtype), vf.to(dtype), ones, ones


def _write_rows(buf, idx, rows, fits):
    """``buf[:, idx] = rows`` where ``fits`` (a bool tensor), else the old
    rows written back; ``idx`` is an index tensor along dim 1."""
    old = buf.index_select(1, idx)
    buf.index_copy_(1, idx, torch.where(fits, rows, old))


def append_kv(cache: KVCache, k_new, v_new, pos=None,
              active=None) -> KVCache:
    """Append one token per replica, in place. ``k_new`` / ``v_new``:
    ``[R_kv, hd]``. Returns the cache with its new ``kv_len``.

    ``pos``: a scalar write position shared by ALL replicas (an int or a
    0-d integer tensor on the cache's device; the uniform serving step):
    one indexed write per buffer. Without it each replica writes at its own
    ``kv_len`` through the ragged-append kernel. ``active`` (ragged path
    only): per-replica write-enable ``[R_kv]``; frozen slots neither write
    nor advance.

    Capacity is enforced on both paths: a replica at ``kv_len == s_max``
    (or a shared ``pos >= s_max``) keeps its cache bit-identical (the
    uniform path writes the old row back) and its length pinned at
    ``s_max``."""
    R, s_max, _ = cache.k.shape
    kq, vq, ks, vs = pad_quantize_tokens(k_new, v_new, cache.k.dtype)
    dev = cache.k.device

    if pos is not None:
        if active is not None:
            raise ValueError("active mask requires the ragged path "
                             "(pos=None); a uniform batch freezes no slots")
        p_raw = torch.as_tensor(pos, device=dev).long().reshape(1)
        idx = p_raw.clamp(max=s_max - 1)
        fits = p_raw < s_max
        _write_rows(cache.k, idx, kq[:, None], fits)
        _write_rows(cache.v, idx, vq[:, None], fits)
        _write_rows(cache.k_scale, idx, ks[:, None], fits)
        _write_rows(cache.v_scale, idx, vs[:, None], fits)
        return cache.with_len(torch.clamp(cache.kv_len + 1, max=s_max))

    ok = (torch.ones((R,), dtype=torch.int32, device=dev) if active is None
          else torch.as_tensor(active, device=dev).to(torch.int32))
    ragged_append_kernel(cache.kv_len, ok.contiguous(), kq.contiguous(),
                         vq.contiguous(), ks.contiguous(), vs.contiguous(),
                         cache.k, cache.v, cache.k_scale, cache.v_scale)
    adv = ok * (cache.kv_len < s_max).to(torch.int32)
    return cache.with_len(cache.kv_len + adv)


def append_kv_seq(cache: KVCache, k_new, v_new, pos) -> KVCache:
    """Append ``q`` tokens per replica at the shared position ``pos``
    (speculative decode), in place. ``k_new`` / ``v_new``: ``[R_kv, q,
    hd]``. All or nothing: if the ``q`` tokens do not all fit below
    ``s_max`` the cache stays bit-identical and ``kv_len`` does not
    advance (a partial draft write would desync rollback)."""
    R, s_max, _ = cache.k.shape
    q = k_new.shape[1]
    kq, vq, ks, vs = pad_quantize_tokens(k_new, v_new, cache.k.dtype)
    dev = cache.k.device
    p_raw = torch.as_tensor(pos, device=dev).long().reshape(1)
    idx = p_raw.clamp(max=s_max - q) + torch.arange(q, device=dev)
    fits = p_raw <= s_max - q
    _write_rows(cache.k, idx, kq, fits)
    _write_rows(cache.v, idx, vq, fits)
    _write_rows(cache.k_scale, idx, ks, fits)
    _write_rows(cache.v_scale, idx, vs, fits)
    return cache.with_len(torch.where(fits, cache.kv_len + q, cache.kv_len))


def prefill_kv(cache: KVCache, k_seq, v_seq, lengths=None) -> KVCache:
    """Bulk-write a prompt into an (empty) cache from position 0, in place.
    ``k_seq`` / ``v_seq``: ``[R_kv, T, hd]``; ``lengths``: ``i32[R_kv]``
    valid tokens per replica (default: all ``T``). Pad tokens are zeroed
    before quantising (their int8 scales become the floor)."""
    R, s_max, _ = cache.k.shape
    T = k_seq.shape[1]
    dev = cache.k.device
    if T > s_max:
        raise ValueError(f"prompt length {T} > s_max {s_max}")
    if lengths is None:
        lengths = torch.full((R,), T, dtype=torch.int32, device=dev)
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
    mask = (torch.arange(T, device=dev)[None, :] < lengths[:, None])[..., None]
    kq, vq, ks, vs = pad_quantize_tokens(
        torch.where(mask, k_seq.float(), 0.0),
        torch.where(mask, v_seq.float(), 0.0), cache.k.dtype)
    cache.k[:, :T] = kq
    cache.v[:, :T] = vq
    cache.k_scale[:, :T] = ks
    cache.v_scale[:, :T] = vs
    return cache.with_len(lengths)


def insert_kv_slot(cache: KVCache, src: KVCache, slot, *,
                   kv_heads: int) -> KVCache:
    """Admit a sequence into batch slot ``slot`` (continuous batching), in
    place: the ``kv_heads`` replicas of the slot (rows ``slot * kv_heads``
    up to ``(slot + 1) * kv_heads``) take ``src``'s, a single-sequence cache
    from a ``batch=1`` prefill. ``src`` may have a smaller ``s_max`` (its
    tokens land at ``[0, src.s_max)``; the stale tail is never read, since
    ``kv_len`` is overwritten too). ``slot`` is an int, checked against the
    slot count, or a 0-d tensor, clamped into range as JAX's
    ``dynamic_update_slice`` does."""
    if src.k.dtype != cache.k.dtype:
        raise ValueError(f"src cache dtype {src.k.dtype} != {cache.k.dtype}")
    if src.k.shape[-1] != cache.k.shape[-1]:
        raise ValueError(f"src hd {src.k.shape[-1]} != {cache.k.shape[-1]}")
    if src.k.shape[0] != kv_heads:
        raise ValueError(f"src has {src.k.shape[0]} replicas, expected "
                         f"kv_heads {kv_heads}")
    if src.s_max > cache.s_max:
        raise ValueError(f"src s_max {src.s_max} > cache s_max "
                         f"{cache.s_max}")
    n_slots = cache.k.shape[0] // kv_heads
    dev = cache.k.device
    if isinstance(slot, (int, np.integer)):
        if not 0 <= slot < n_slots:
            raise ValueError(f"slot {slot} out of range [0, {n_slots})")
    slot_t = torch.as_tensor(slot, device=dev).long().clamp(0, n_slots - 1)
    rows = slot_t * kv_heads + torch.arange(kv_heads, device=dev)
    n = src.s_max
    for dst, s in ((cache.k, src.k), (cache.v, src.v),
                   (cache.k_scale, src.k_scale), (cache.v_scale, src.v_scale)):
        dst[:, :n].index_copy_(0, rows, s.to(dev))
    kv_len = cache.kv_len.clone()
    kv_len.index_copy_(0, rows, src.kv_len.to(device=dev, dtype=torch.int32))
    return cache.with_len(kv_len)


def decode_block_table(kv_len, *, s_max: int, bk: int, window_blocks: int,
                       sink_blocks: int = 1):
    """Attention-sinks + local-window block table, computed on the device.

    Returns ``(tbl i32[R, S], valid i32[R, S])`` with
    ``S = sink_blocks + window_blocks``. Window blocks inside the sink
    range (or before block 0) are invalid and take the running last valid
    id (the first slot's id if none is valid yet), as the JAX package's
    ``associative_scan`` gives them; a ``cummax`` over the valid positions
    does the same here. The window is BLOCK-granular: the last
    ``window_blocks`` whole ``bk``-token blocks are attended."""
    kv_len = kv_len.long()
    dev = kv_len.device
    R = kv_len.shape[0]
    nb = s_max // bk
    last = torch.clamp(torch.div(kv_len - 1, bk, rounding_mode="floor"),
                       min=0)                                      # [R]
    sink = torch.arange(sink_blocks, device=dev).expand(R, sink_blocks)
    win = (last[:, None] - (window_blocks - 1)
           + torch.arange(window_blocks, device=dev)[None, :])     # [R, Sw]
    nonempty = (kv_len > 0)[:, None]
    sink_ok = (sink <= last[:, None]) & nonempty
    win_ok = (win >= sink_blocks) & (win <= last[:, None]) & nonempty
    tbl = torch.cat([sink, win.clamp(0, nb - 1)], dim=1)
    valid = torch.cat([sink_ok, win_ok], dim=1)
    S = tbl.shape[1]
    at = torch.where(valid, torch.arange(S, device=dev)[None, :], 0)
    prev = torch.gather(tbl, 1, torch.cummax(at, dim=1).values)
    return (torch.where(valid, tbl, prev).to(torch.int32),
            valid.to(torch.int32))


def table_from_topology_row(topo, row: int, bk: int):
    """Static block table (numpy) from one row of a ``SparseTopology``: the
    ``bk``-sized KV blocks the row's column indices touch."""
    lo, hi = int(topo.row_offsets[row]), int(topo.row_offsets[row + 1])
    cols = np.asarray(topo.column_indices[lo:hi])
    blocks = np.unique(cols // bk).astype(np.int32)
    if blocks.size == 0:
        return np.zeros((1,), np.int32), np.zeros((1,), np.int32)
    return blocks, np.ones_like(blocks)


def decode_attention(q, cache: KVCache, tbl, valid, *, bk: int = 256,
                     qlen: int = 1, group: int = 1,
                     scale: Optional[float] = None):
    """Sparse decode attention: ``q [R, qlen, hd]`` against the tabled KV
    blocks -> ``f32[R, qlen, hd]``.

    ``tbl`` / ``valid``: ``i32[R, S]`` per QUERY replica, or ``[R_kv, S]``
    per KV replica (what ``decode_block_table`` gives for a grouped cache),
    expanded here so each query group reads its KV replica's table (the
    kernel indexes tables by query replica). ``group``: query replicas per
    KV replica (GQA). ``qlen > 1``: speculative verification, the queries
    being the last ``qlen`` cache positions, causally masked."""
    R, qn, hd = q.shape
    R_kv = cache.k.shape[0]
    if qn != qlen:
        raise ValueError(f"q has qlen {qn}, expected {qlen}")
    if qlen > QPAD:
        raise ValueError(f"qlen > {QPAD} not supported (got {qlen})")
    if cache.s_max % bk:
        raise ValueError(f"s_max {cache.s_max} not a multiple of bk {bk}")
    if R != R_kv * group:
        raise ValueError(f"R {R} != R_kv {R_kv} * group {group}")
    if group > 1 and tbl.shape[0] == R_kv:
        tbl = tbl.repeat_interleave(group, dim=0)
        valid = valid.repeat_interleave(group, dim=0)
    if tbl.shape[0] != R or valid.shape[0] != R:
        raise ValueError(f"tbl/valid rows {tbl.shape[0]}/{valid.shape[0]} "
                         f"!= R {R} (or R_kv {R_kv})")
    scale = float(scale) if scale is not None else float(hd) ** -0.5
    return decode_attention_kernel(
        tbl.to(torch.int32).contiguous(), valid.to(torch.int32).contiguous(),
        cache.kv_len.to(torch.int32).contiguous(), q.float().contiguous(),
        cache.k, cache.v, cache.k_scale, cache.v_scale, bk=bk, qlen=qlen,
        group=group, scale=scale)
