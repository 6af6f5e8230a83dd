"""The KV append on the paged pool (B20b): the CUDA kernel's wrapper and its
plain PyTorch versions.

Replaces ``sputnik_tpu/ops/pallas/paged_attention.py:paged_append_kernel``
and the composite around it (JAX's ``pad_quantize_tokens``,
``_resolve_write`` and the length update); the kernel is
``csrc/ragged_append.cu`` (entry ``paged_append``), B21's body under the
paged address policy. One launch per call does the whole append of a layer:
replica ``r`` writes its ``q`` tokens (1 for a decode step, a draft for
speculative verification) into pool rows ``page * bk + (kv_len[r] + t) %
bk``, ``page = page_table[r, (kv_len[r] + t) // bk]``, all of them or, if
one has no page, is past the table's capacity or ``active[r] != 1``, none
(JAX's kernel writes the old bytes back to its dump page, a rule of the
TPU's pipelined grid; the port writes nothing). The new lengths, ``kv_len +
q`` where written, go to a fresh ``int32[R]`` tensor. A table id past the
pool (``>= P_alloc``; the allocator never hands one out) counts as a page
for the length, as in JAX's ``_resolve_write``, but its token is not
stored: JAX's write clamps into its dump page, the port's skips it.

``paged_append_plain`` is B20b's byte write alone (tested against JAX's
Pallas kernel); ``paged_append_fused_plain`` is the whole append built on
it, which CPU tensors run.
"""

from __future__ import annotations

import torch

from ._build import check, library
from .ragged_append import (CACHE_DTYPES, TOK_DTYPES, _as_draft,
                            check_cache, device_args, pad_quantize_tokens,
                            token_args)

__all__ = ["paged_append_kernel", "paged_append_fused_plain",
           "paged_append_plain"]


def paged_append_plain(page, off, ok, tok_k, tok_v, tok_ks, tok_vs, k_pool,
                       v_pool, ks_pool, vs_pool) -> None:
    """B20b's byte write: in place, ``k_pool[page[r], off[r]] = tok_k[r]``
    (and ``v``, and the two scales) where ``ok[r] == 1``, ``0 <= page[r] <
    P_alloc`` and ``0 <= off[r] < bk``; one indexed write per buffer, of
    the writing replicas' rows only (a boolean selection, so it reads the
    mask on the host). ``page / off / ok i32[R]``, tokens ``[R, hd]`` in
    the pool dtype, token scales ``f32[R]``."""
    P, bk, hd = k_pool.shape
    write = (ok == 1) & (page >= 0) & (page < P) & (off >= 0) & (off < bk)
    rows = (page.long() * bk + off.long())[write]
    k_pool.view(P * bk, hd)[rows] = tok_k[write]
    v_pool.view(P * bk, hd)[rows] = tok_v[write]
    ks_pool.view(P * bk)[rows] = tok_ks[write]
    vs_pool.view(P * bk)[rows] = tok_vs[write]


def paged_append_fused_plain(k_new, v_new, k_pool, v_pool, ks_pool, vs_pool,
                             page_table, kv_len, active=None):
    """Plain version of the whole append (see ``paged_append_kernel``): the
    write rule, the all-or-nothing slot of each replica, then
    ``paged_append_plain`` once per draft token, then the new lengths."""
    bk = k_pool.shape[1]
    mb = page_table.shape[1]
    k3, v3 = _as_draft(k_new, v_new)
    q = k3.shape[1]
    kq, vq, ks, vs = pad_quantize_tokens(k3, v3, k_pool.dtype)
    pos = kv_len.long()[:, None] + torch.arange(q, device=kv_len.device)
    pages = torch.gather(page_table.long(), 1, (pos // bk).clamp(0, mb - 1))
    fits = ((pages >= 0) & (pos >= 0) & (pos < mb * bk)).all(1)
    if active is not None:
        fits = fits & (active == 1)
    ok = fits.to(torch.int32)
    for t in range(q):
        paged_append_plain(pages[:, t].to(torch.int32),
                           (pos[:, t] % bk).to(torch.int32), ok, kq[:, t],
                           vq[:, t], ks[:, t], vs[:, t], k_pool, v_pool,
                           ks_pool, vs_pool)
    return kv_len + ok * q


def paged_append_kernel(k_new, v_new, k_pool, v_pool, ks_pool, vs_pool,
                        page_table, kv_len, active=None):
    """``[R, hd]`` tokens or ``[R, q, hd]`` drafts, f32 or bf16, any
    strides with a unit last one, written into the pool ``[P_alloc, bk,
    hd]`` and its scales ``f32[P_alloc, bk]`` in place through
    ``page_table`` ``i32[R, max_blocks]`` at each replica's ``kv_len``;
    ``active``: ``i32[R]`` or None. Returns the new ``kv_len`` (a fresh
    ``i32[R]``). One launch on CUDA; CPU tensors run
    ``paged_append_fused_plain``."""
    P, bk, hd = k_pool.shape
    R, mb = page_table.shape
    k, v, q, strides = token_args("paged_append", k_new, v_new, R, hd)
    check_cache("paged_append", k_pool, v_pool, ks_pool, vs_pool, kv_len,
                (P, bk), R)
    if not k_pool.is_cuda:
        return paged_append_fused_plain(k, v, k_pool, v_pool, ks_pool,
                                        vs_pool, page_table, kv_len, active)
    dev = k_pool.device
    idx = (kv_len, page_table) + (() if active is None else (active,))
    if page_table.dtype != torch.int32 or (
            active is not None and (active.dtype != torch.int32
                                    or active.shape != (R,))):
        raise ValueError(f"paged_append: page_table and active must be "
                         f"int32 ([{R}] for active)")
    ptrs, vec = device_args("paged_append", k, v, strides,
                            (k_pool, v_pool, ks_pool, vs_pool), idx, dev)
    new_len = torch.empty((R,), dtype=torch.int32, device=dev)
    if R == 0:
        return new_len
    err = library().paged_append(
        ptrs[0], ptrs[1], kv_len.data_ptr(), page_table.data_ptr(),
        None if active is None else active.data_ptr(), new_len.data_ptr(),
        *ptrs[2:], *strides, TOK_DTYPES.index(k.dtype),
        CACHE_DTYPES.index(k_pool.dtype),
        R, q, hd, bk, mb, P, vec,
        torch._C._cuda_getCurrentRawStream(dev.index))
    check(err, "paged_append")
    paged_append_kernel.launches += 1
    return new_len


paged_append_kernel.launches = 0
