"""Paged serving runtime: ``SparseDecoder`` over a shared KV page pool
(counterpart of ``sputnik_tpu/models/serving_paged.py``).

``PagedDecoder`` keeps the whole ``SparseDecoder`` surface (prefill through
the sparse-flash kernel, decode steps, GQA, sinks + window tables, bf16 /
f32 / int8 KV) but stores KV in one page pool per layer (``ops/paged.py``)
instead of per-slot contiguous buffers: the memory held for a ragged batch
is the tokens written plus under one page per (slot, KV head, layer), and
slots are admitted and evicted without copying cache data.

Scheduling contract: ``reserve(caches, n)`` is a HOST step that allocates
pages for the next ``n`` tokens (it syncs; call it between decode steps);
the decode steps themselves never sync the host. ``release(caches, slot)``
returns a finished sequence's pages to the pools; ``share_prefix`` admits a
slot with another slot's prefix. The inherited ``decode_loop`` needs
``reserve(caches, n_tokens)`` first, as every decode step does (an append
without a page writes nothing). As in ``SparseDecoder``, methods take no
``params``: the decoder reads its model's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import paged as pg
from ..ops.decode import decode_block_table
from .serving import SparseDecoder, Step, _run_one

__all__ = ["PagedDecoder"]


class PagedDecoder(SparseDecoder):
    """Generation runtime over a page pool.

    Args (beyond ``SparseDecoder``'s):
      n_pages: pool capacity per layer, in pages of ``bk`` tokens, SHARED
        by all ``batch * kv_heads`` replicas. Size it as
        ``ceil(expected_total_tokens / bk) + batch * kv_heads`` (one
        partly filled page per replica).
      s_max: here the per-sequence LENGTH CAP (the table's width), not a
        per-slot reservation: memory scales with the tokens written.
      bk: the page size, a multiple of 128 (as in the JAX package).
    """

    def __init__(self, model, *, n_pages: int, s_max: int, bk: int = 256,
                 window=None, sinks: int = 0, cache_dtype=torch.bfloat16):
        super().__init__(model, s_max=s_max, bk=bk, window=window,
                         sinks=sinks, cache_dtype=cache_dtype)
        self.n_pages = n_pages
        self.pools: List[pg.PagePool] = []

    # -- cache management ---------------------------------------------------

    def init_caches(self, batch: int) -> Tuple[pg.PagedKVCache, ...]:
        """One pooled cache per layer (the allocators live on the
        decoder)."""
        caches, self.pools = [], []
        for _ in range(self.model.num_layers):
            c, pool = pg.init_paged_cache(
                batch * self.kv_heads, self.n_pages, self.bk, self.hd,
                self.nb, dtype=self.cache_dtype, device=self.device)
            caches.append(c)
            self.pools.append(pool)
        return tuple(caches)

    def reserve(self, caches: Sequence[pg.PagedKVCache],
                n_tokens: int = 1) -> Tuple[pg.PagedKVCache, ...]:
        """HOST scheduler step: allocate pages for the next ``n_tokens``
        appends on every layer (syncs the host)."""
        return tuple(pg.ensure_pages(c, pool, n_tokens)
                     for c, pool in zip(caches, self.pools))

    def release(self, caches: Sequence[pg.PagedKVCache],
                slot: int) -> Tuple[pg.PagedKVCache, ...]:
        """Evict a finished sequence: free its pages on every layer."""
        return tuple(pg.free_pages_of(c, pool, slot, kv_heads=self.kv_heads)
                     for c, pool in zip(caches, self.pools))

    def share_prefix(self, caches: Sequence[pg.PagedKVCache], src: int,
                     dst: int, n_tokens: int) -> Tuple[pg.PagedKVCache, ...]:
        """Prefix caching (host step): admit slot ``dst`` with slot
        ``src``'s first ``n_tokens`` (a system prompt, a shared context):
        full pages are shared by refcount, only a partial tail page is
        copied. ``dst`` must be released first."""
        return tuple(pg.share_prefix(c, pool, src, dst, n_tokens,
                                     kv_heads=self.kv_heads)
                     for c, pool in zip(caches, self.pools))

    @property
    def free_pages(self) -> List[int]:
        return [p.free_pages for p in self.pools]

    # -- prefill: SparseDecoder.prefill with the two cache hooks -------------

    def _prefill_setup(self, caches, T: int):
        if T % self.bk:
            raise ValueError(f"prompt length {T} must pad to bk={self.bk}")
        return self.reserve(caches, T)          # pages for the whole prompt

    def _prefill_write(self, cache, k3, v3, len_r):
        # the table's prompt blocks as DEVICE page ids (a device scatter,
        # no host read): the prompt's pages were reserved by _prefill_setup
        T = k3.shape[1]
        return pg.write_prompt_pages(
            cache, k3, v3, replica_pages=cache.page_table[:, : T // self.bk],
            lengths=len_r)

    # -- decode --------------------------------------------------------------

    def _plan_paged(self, x, caches, append_fn, qlen, advance):
        """The decode shard shared by the uniform, ragged and speculative
        steps: per layer, append through ``append_fn(cache, k3, v3)`` and
        attend through the step's tables.

        Both tables are built ONCE per step, not per layer: the logical one
        depends only on the lengths, and the physical one too, because
        every layer's pool sees the same reserve / release / share_prefix
        calls in the same order (this class is their only caller), so the
        layers' page tables (and lengths) are identical."""
        b = x.shape[0]
        scale = 1.0 / float(np.sqrt(self.hd))
        c0 = caches[0]
        kv_len1 = torch.clamp(c0.kv_len + advance, max=self.nb * self.bk)
        logical, valid = decode_block_table(
            kv_len1, s_max=self.s_max, bk=self.bk,
            window_blocks=self.window_blocks, sink_blocks=self.sink_blocks)
        phys, valid = pg.physical_table(c0, logical, valid)

        def attn(li, q, k, v):
            cache = step.caches[li] = append_fn(
                step.caches[li], self._fold(k), self._fold(v))
            ctx = pg.paged_attention(self._fold(q), cache, phys, logical,
                                     valid, group=self.group, qlen=qlen,
                                     scale=scale)
            return self._unfold(ctx, b)

        step = Step(self, x, caches, attn)
        return step

    def _plan_step(self, x_tok, caches, active=None):
        act_r = None
        if active is not None:
            act_r = torch.as_tensor(active, device=x_tok.device).to(
                torch.int32).repeat_interleave(self.kv_heads)

        def append(cache, k3, v3):
            return pg.append_paged(cache, k3[:, 0], v3[:, 0], act_r)

        return self._plan_paged(x_tok, caches, append, 1,
                                act_r if act_r is not None else 1)

    _plan_ragged = _plan_step

    def _plan_multi(self, x_toks, caches):
        def append(cache, k3, v3):
            return pg.append_paged_seq(cache, k3, v3)

        qn = x_toks.shape[1]
        return self._plan_paged(x_toks, caches, append, qn, qn)

    @torch.no_grad()
    def decode_step(self, x_tok, caches: Sequence[pg.PagedKVCache],
                    active=None, reduce_fn=None):
        """One token per sequence (run ``reserve`` first): ``x_tok [b, 1,
        h]`` -> ``(y [b, 1, h], caches)``. Paged appends are per replica by
        construction (each replica's page differs), so uniform and ragged
        batches share this step; ``active`` (bool ``[b]``) freezes finished
        slots as the contiguous ragged step does."""
        return _run_one(self._plan_step(x_tok, caches, active), reduce_fn)

    def decode_step_ragged(self, x_tok, caches: Sequence[pg.PagedKVCache],
                           active=None, reduce_fn=None):
        """The same step as ``decode_step``: paged appends are per replica
        by construction."""
        return self.decode_step(x_tok, caches, active=active,
                                reduce_fn=reduce_fn)

    @torch.no_grad()
    def decode_multi(self, x_toks, caches: Sequence[pg.PagedKVCache],
                     reduce_fn=None):
        """Speculative verification over the pool: advance ``q <= 8`` draft
        tokens at once (``reserve(caches, q)`` first). All or nothing per
        replica: a replica whose draft does not fit (pages or table) writes
        nothing and its ``kv_len`` stays, the rejection signal. Reject
        tokens with the per-slot ``rollback``."""
        return _run_one(self._plan_multi(x_toks, caches), reduce_fn)

    def rollback(self, caches: Sequence[pg.PagedKVCache],
                 n) -> Tuple[pg.PagedKVCache, ...]:
        """Reject the last ``n`` speculative tokens: shrink ``kv_len``
        (pages stay allocated; later appends overwrite in place).

        ``n`` is a scalar (uniform batch) or PER SLOT ``[b]``: a batched
        speculative loop accepts different prefix lengths per sequence, and
        a rejected slot (``kv_len`` unchanged) must roll back zero."""
        dev = caches[0].kv_len.device
        n = torch.as_tensor(n, device=dev).to(torch.int32)
        if n.dim() == 1:
            n = n.repeat_interleave(self.kv_heads)
        return tuple(dataclasses.replace(c, kv_len=torch.clamp(
            c.kv_len - n, min=0)) for c in caches)
