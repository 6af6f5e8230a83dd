"""Paged KV cache: a shared page pool and per-sequence page tables
(counterpart of ``sputnik_tpu/ops/paged.py``).

The block cache (``ops/decode.py``) reserves ``s_max`` tokens per replica.
Here KV lives in one pool ``[P_alloc, bk, hd]`` per layer, and each replica
owns an ordered list of pages (``page_table``): the memory held is the
tokens written plus under one page per replica, and slots are admitted and
evicted without moving data.

Division of labour, as in the JAX package:

  * DEVICE (no host sync): ``append_paged`` / ``append_paged_seq``, each
    one launch of the paged KV-append kernel, ``paged_block_table``
    (logical sinks + window table -> physical pages) and
    ``paged_attention`` through the paged-attention kernel.
  * HOST (the scheduler, between decode steps): ``PagePool``, a free list
    with refcounts; ``ensure_pages``, ``free_pages_of`` and
    ``share_prefix``. They read ``kv_len`` / ``page_table`` to the host, as
    JAX's do: each is a sync point by design. ``write_prompt_pages`` takes
    host page ids (checked) or device ids (a device scatter, as the
    decoders' prefill passes them).

**Writes are in place**, as in ``ops/decode.py``: the returned
``PagedKVCache`` shares the pool buffers (and, where only the pool changed,
the table) with the one passed in.

TPU layouts do not carry over: no 128-lane ``hd_pad`` (the pool is
``[P_alloc, bk, hd]``) and no pad of ``P_alloc`` to 8 (``P_alloc = n_pages +
1``). Row ``n_pages`` is the dump page: it is never allocated, and invalid
table slots point at it. A skipped append writes nothing at all (JAX's
kernel writes the old bytes back to the dump page). ``bk % 128 == 0`` is
kept so both packages accept the same configurations.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .decode import QPAD, decode_block_table, pad_quantize_tokens
from .kernels.paged_append import paged_append_kernel
from .kernels.paged_attention import paged_attention_kernel
from .kernels.ragged_append import as_i32

__all__ = ["PagePool", "PagedKVCache", "init_paged_cache", "ensure_pages",
           "append_paged", "append_paged_seq", "paged_block_table",
           "paged_attention", "write_prompt_pages", "share_prefix",
           "free_pages_of", "physical_table"]


class PagePool:
    """Host-side free-list allocator over page ids ``[0, n_pages)``, with a
    refcount per page (prefix caching shares full pages)."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._rc = np.zeros(n_pages, np.int32)   # 0 = free

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)} "
                f"of {self.n_pages} (evict finished sequences first)")
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._rc[i] = 1
        return ids

    def share(self, ids) -> None:
        """Bump refcounts (prefix caching: several sequences' tables point
        at the same immutable full pages)."""
        for i in ids:
            if self._rc[i] <= 0:
                raise ValueError(f"sharing unallocated page {i}")
            self._rc[i] += 1

    def free(self, ids) -> None:
        """Drop one reference per id; a page returns to the free list only
        when its last reference goes."""
        for i in ids:
            if not 0 <= i < self.n_pages:
                raise ValueError(f"freeing foreign page id {i}")
            if self._rc[i] <= 0:
                raise ValueError(f"double free of page {i}")
            self._rc[i] -= 1
            if self._rc[i] == 0:
                self._free.append(int(i))


@dataclasses.dataclass(frozen=True)
class PagedKVCache:
    """Pooled KV. ``k`` / ``v``: ``[P_alloc, bk, hd]`` (``P_alloc =
    n_pages + 1``, the last row the dump page); ``k_scale`` / ``v_scale``:
    ``f32[P_alloc, bk]``; ``page_table``: ``i32[R_kv, max_blocks]``
    physical page per logical block (-1 = unallocated); ``kv_len``:
    ``i32[R_kv]``. All on the device."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    page_table: torch.Tensor
    kv_len: torch.Tensor

    @property
    def is_int8(self) -> bool:
        return self.k.dtype == torch.int8

    @property
    def bk(self) -> int:
        return self.k.shape[1]

    @property
    def max_blocks(self) -> int:
        return self.page_table.shape[1]

    @property
    def dump_page(self) -> int:
        """The last pool row, never allocated: invalid table slots aim
        here."""
        return self.k.shape[0] - 1

    def clone(self) -> "PagedKVCache":
        """A copy whose buffers later in-place writes do not touch."""
        return PagedKVCache(*(t.clone() for t in dataclasses.astuple(self)))


def init_paged_cache(R_kv: int, n_pages: int, bk: int, hd: int,
                     max_blocks: int, dtype=torch.bfloat16,
                     device=None) -> Tuple[PagedKVCache, PagePool]:
    """Empty pooled cache and its host allocator. ``bk`` (page size in
    tokens) must be a multiple of 128; ``max_blocks`` bounds any single
    sequence at ``max_blocks * bk`` tokens."""
    if bk % 128:
        raise ValueError(f"bk {bk} must be a multiple of 128")
    P_alloc = n_pages + 1                    # + the dump page
    cache = PagedKVCache(
        k=torch.zeros((P_alloc, bk, hd), dtype=dtype, device=device),
        v=torch.zeros((P_alloc, bk, hd), dtype=dtype, device=device),
        k_scale=torch.ones((P_alloc, bk), device=device),
        v_scale=torch.ones((P_alloc, bk), device=device),
        page_table=torch.full((R_kv, max_blocks), -1, dtype=torch.int32,
                              device=device),
        kv_len=torch.zeros((R_kv,), dtype=torch.int32, device=device))
    return cache, PagePool(n_pages)


def _host(t) -> np.ndarray:
    """A device tensor as a writable numpy copy (a host sync)."""
    return t.detach().cpu().numpy().copy()


def ensure_pages(cache: PagedKVCache, pool: PagePool, n_tokens: int = 1,
                 replicas=None) -> PagedKVCache:
    """HOST scheduler step: make sure the next ``n_tokens`` appends have
    pages. Reads ``kv_len`` / ``page_table`` to the host (a sync point:
    call it between decode steps), allocates the missing pages, and returns
    the cache with the updated table. ``replicas``: optional iterable
    restricting which replica rows grow."""
    kv_len = _host(cache.kv_len)
    table = _host(cache.page_table)
    bk = cache.bk
    rows = range(table.shape[0]) if replicas is None else replicas
    # two phases: collect every hole first, allocate ONCE, then fill, so a
    # raise (pool exhausted, capacity) leaks no page into a dropped table
    holes = []
    for r in rows:
        last = (int(kv_len[r]) + n_tokens - 1) // bk
        if last >= table.shape[1]:
            raise ValueError(
                f"replica {r} needs block {last} >= max_blocks "
                f"{table.shape[1]}")
        # fill from block 0: admission can set kv_len directly (prefix
        # shares, restores), so earlier blocks may still be holes
        holes.extend((r, b) for b in range(0, last + 1) if table[r, b] < 0)
    if not holes:
        return cache
    pages = pool.allocate(len(holes))       # atomic: raises before popping
    for (r, b), p in zip(holes, pages):
        table[r, b] = p
    return dataclasses.replace(
        cache, page_table=torch.from_numpy(table).to(cache.kv_len.device))


def free_pages_of(cache: PagedKVCache, pool: PagePool, replica: int,
                  kv_heads: int = 1) -> PagedKVCache:
    """Evict a finished sequence (host step): return the pages of its
    ``kv_heads`` replica rows to the pool, blank those rows and zero their
    lengths."""
    table = _host(cache.page_table)
    kv_len = _host(cache.kv_len)
    for r in range(replica * kv_heads, (replica + 1) * kv_heads):
        pool.free([int(p) for p in table[r] if p >= 0])
        table[r] = -1
        kv_len[r] = 0
    dev = cache.kv_len.device
    return dataclasses.replace(cache,
                               page_table=torch.from_numpy(table).to(dev),
                               kv_len=torch.from_numpy(kv_len).to(dev))


def share_prefix(cache: PagedKVCache, pool: PagePool, src: int, dst: int,
                 n_tokens: int, *, kv_heads: int = 1) -> PagedKVCache:
    """Prefix caching (host step): point slot ``dst``'s tables at slot
    ``src``'s first ``n_tokens`` of KV.

    Full prefix pages are SHARED by refcount: appends only ever touch a
    replica's own tail page, so they are never written again. A partial
    last page (``n_tokens % bk != 0``) is copied on the device into a fresh
    page that ``dst`` owns, where ``dst``'s next appends land. ``dst``'s
    previous pages must already be released."""
    bk = cache.bk
    table = _host(cache.page_table)
    kv_len = _host(cache.kv_len)
    full, rem = divmod(n_tokens, bk)
    copies = []
    for h in range(kv_heads):
        rs = src * kv_heads + h
        rd = dst * kv_heads + h
        if int(kv_len[rs]) < n_tokens:
            raise ValueError(
                f"src replica {rs} holds {int(kv_len[rs])} < {n_tokens}")
        if (table[rd] >= 0).any() or int(kv_len[rd]) != 0:
            raise ValueError(f"dst replica {rd} not released")
        shared = [int(p) for p in table[rs, :full]]
        if any(p < 0 for p in shared):
            raise ValueError("src prefix has unallocated pages")
        pool.share(shared)
        table[rd, :full] = shared
        if rem:
            new = pool.allocate(1)[0]
            copies.append((int(table[rs, full]), new))
            table[rd, full] = new
        kv_len[rd] = n_tokens
    dev = cache.kv_len.device
    if copies:
        srcp, dstp = (torch.tensor(c, device=dev) for c in zip(*copies))
        for buf in (cache.k, cache.v, cache.k_scale, cache.v_scale):
            buf[dstp] = buf[srcp]
    return dataclasses.replace(cache,
                               page_table=torch.from_numpy(table).to(dev),
                               kv_len=torch.from_numpy(kv_len).to(dev))


def append_paged(cache: PagedKVCache, k_new, v_new,
                 active=None) -> PagedKVCache:
    """Append one token per replica into its current page, in place, in ONE
    kernel launch (the write rule, the write slot from ``kv_len`` and the
    page table, the guarded write and the new lengths). ``k_new`` /
    ``v_new``: ``[R_kv, hd]`` (``[R_kv, q, hd]``: a draft, all or nothing,
    as ``append_paged_seq``), f32 or bf16, any strides. A replica with no
    page for its next position (run ``ensure_pages`` first), at its
    table's capacity, or with ``active == 0`` writes nothing and does not
    advance. Returns the cache with a new ``kv_len`` tensor."""
    if active is not None:
        active = as_i32(active, cache.k.device)
    return PagedKVCache(cache.k, cache.v, cache.k_scale, cache.v_scale,
                        cache.page_table, paged_append_kernel(
                            k_new, v_new, cache.k, cache.v, cache.k_scale,
                            cache.v_scale, cache.page_table, cache.kv_len,
                            active))


def append_paged_seq(cache: PagedKVCache, k_new, v_new,
                     active=None) -> PagedKVCache:
    """Append ``q <= 8`` tokens per replica (speculative drafts), in place,
    in one kernel launch. ``k_new`` / ``v_new``: ``[R_kv, q, hd]``.

    ALL OR NOTHING per replica: a replica whose ``q`` positions are not
    all page-backed and below the table's capacity writes nothing and does
    not advance (a partial draft write would desync rollback). Tokens may
    cross a page boundary."""
    q = k_new.shape[1]
    if q > QPAD:
        raise ValueError(f"draft length {q} > {QPAD}")
    return append_paged(cache, k_new, v_new, active)


def write_prompt_pages(cache: PagedKVCache, k_seq, v_seq, *,
                       replica_pages, lengths=None) -> PagedKVCache:
    """Bulk prefill write of each prompt block into its page, in place.

    ``k_seq`` / ``v_seq``: ``[R_kv, T, hd]``; ``replica_pages``:
    ``i32[R_kv, T // bk]``, the physical page of each prompt block (from
    ``ensure_pages`` and the cache's table). ``lengths``: valid tokens per
    replica (pad tokens are zeroed before quantising and never attended,
    thanks to ``kv_len``).

    Host ids (numpy, a list) are checked: an unallocated (< 0) id raises.
    A ``torch.Tensor`` of ids is a DEVICE scatter, JAX's traced branch: no
    host read, and an unallocated id writes the dump page instead of
    raising, so the caller reserves the prompt's pages first (the decoders'
    prefill does)."""
    R, T, hd = k_seq.shape
    bk = cache.bk
    if T % bk:
        raise ValueError(f"prompt length {T} must pad to page size {bk}")
    nb = T // bk
    dev = cache.k.device
    if isinstance(replica_pages, torch.Tensor):
        pages = replica_pages.reshape(-1).to(dev)          # [R * nb]
    else:
        pages = np.asarray(replica_pages).reshape(-1)
    if pages.shape[0] != R * nb:
        raise ValueError(f"replica_pages holds {pages.shape[0]} ids, "
                         f"expected {R} x {nb}")
    if isinstance(pages, torch.Tensor):
        idx = torch.where(pages < 0, cache.dump_page, pages).long()
    elif (pages < 0).any():
        raise ValueError("unallocated page in replica_pages")
    else:
        idx = torch.from_numpy(pages.astype(np.int64)).to(dev)
    if lengths is None:
        lengths = torch.full((R,), T, dtype=torch.int32, device=dev)
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
    mask = (torch.arange(T, device=dev)[None, :] < lengths[:, None])[..., None]
    kq, vq, ks, vs = pad_quantize_tokens(
        torch.where(mask, k_seq.float(), 0.0),
        torch.where(mask, v_seq.float(), 0.0), cache.k.dtype)
    cache.k[idx] = kq.reshape(R * nb, bk, hd)
    cache.v[idx] = vq.reshape(R * nb, bk, hd)
    cache.k_scale[idx] = ks.reshape(R * nb, bk)
    cache.v_scale[idx] = vs.reshape(R * nb, bk)
    return dataclasses.replace(cache, kv_len=lengths)


def physical_table(cache: PagedKVCache, logical, valid):
    """Physical pages of a logical table (device): ``(phys, valid)`` with
    slots whose block has no page made invalid and aimed at the dump
    page."""
    phys = torch.gather(cache.page_table, 1,
                        logical.long().clamp(0, cache.max_blocks - 1))
    valid = valid * (phys >= 0).to(torch.int32)
    phys = torch.where(valid == 1, phys, cache.dump_page)
    return phys.to(torch.int32), valid


def paged_block_table(cache: PagedKVCache, *, window_blocks: int,
                      sink_blocks: int = 0, advance=None):
    """Physical sinks + window table from the cache state, on the device.
    Returns ``(phys i32[R, S], logical i32[R, S], valid i32[R, S])``.
    ``advance``: optional per-replica i32 added to ``kv_len`` first (a
    decode step tables the position AFTER its append)."""
    kv_len = cache.kv_len + (advance if advance is not None else 0)
    logical, valid = decode_block_table(
        kv_len, s_max=cache.max_blocks * cache.bk, bk=cache.bk,
        window_blocks=window_blocks, sink_blocks=sink_blocks)
    phys, valid = physical_table(cache, logical, valid)
    return phys, logical, valid


def paged_attention(q, cache: PagedKVCache, phys, logical, valid, *,
                    group: int = 1, qlen: int = 1,
                    scale: Optional[float] = None):
    """Paged decode attention: ``q [R, qlen, hd]`` against the tabled pool
    pages -> ``f32[R, qlen, hd]``. ``qlen > 1`` serves speculative
    verification (the queries are the last ``qlen`` cache positions,
    causally masked). ``phys`` / ``logical`` / ``valid`` may be per KV
    replica (``[R_kv, S]``): they are expanded per query replica here."""
    R, qn, hd = q.shape
    if qn != qlen:
        raise ValueError(f"q has qlen {qn}, expected {qlen}")
    if qlen > QPAD:
        raise ValueError(f"qlen > {QPAD} not supported (got {qlen})")
    R_kv = cache.kv_len.shape[0]
    if R != R_kv * group:
        raise ValueError(f"R {R} != R_kv {R_kv} * group {group}")
    if group > 1 and phys.shape[0] == R_kv:
        phys, logical, valid = (t.repeat_interleave(group, dim=0)
                                for t in (phys, logical, valid))
    if phys.shape[0] != R:
        raise ValueError(f"table rows {phys.shape[0]} != R {R}")
    scale = float(scale) if scale is not None else float(hd) ** -0.5
    i32 = [t.to(torch.int32).contiguous() for t in (phys, logical, valid,
                                                     cache.kv_len)]
    return paged_attention_kernel(
        *i32, q.float().contiguous(), cache.k, cache.v, cache.k_scale,
        cache.v_scale, qlen=qlen, group=group, scale=scale)
