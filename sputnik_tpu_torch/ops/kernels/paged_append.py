"""Paged KV append: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``sputnik_tpu/ops/pallas/paged_attention.py:paged_append_kernel``;
the kernel is ``csrc/ragged_append.cu`` (entry ``paged_append``), B21's
byte copy with another row index. Replica ``r`` writes its token, in place,
into row ``page[r] * bk + off[r]`` of the pool and its two scales where
``ok[r] == 1``, ``0 <= page[r] < P_alloc`` and ``0 <= off[r] < bk``; any
other replica writes nothing anywhere (JAX's kernel writes the old bytes
back to its dump page, a rule of the TPU's pipelined grid). ``kv_len``
advances outside.
"""

from __future__ import annotations

import torch

from . import check_operands
from ._build import check, library

__all__ = ["paged_append_kernel", "paged_append_plain"]

_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def _check(page, off, ok, tok_k, tok_v, tok_ks, tok_vs, k_pool, v_pool,
           ks_pool, vs_pool):
    P, bk, hd = k_pool.shape
    R = page.shape[0]
    if k_pool.dtype not in _DTYPES:
        raise TypeError(f"pool dtype {k_pool.dtype}: expected one of "
                        f"{list(_DTYPES)}")
    for name, t, shape in (("v_pool", v_pool, (P, bk, hd)),
                           ("tok_k", tok_k, (R, hd)), ("tok_v", tok_v, (R, hd)),
                           ("ks_pool", ks_pool, (P, bk)),
                           ("vs_pool", vs_pool, (P, bk)),
                           ("tok_ks", tok_ks, (R,)), ("tok_vs", tok_vs, (R,)),
                           ("page", page, (R,)), ("off", off, (R,)),
                           ("ok", ok, (R,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"paged_append: {name} {tuple(t.shape)} != "
                             f"{shape}")


def paged_append_plain(page, off, ok, tok_k, tok_v, tok_ks, tok_vs, k_pool,
                       v_pool, ks_pool, vs_pool) -> None:
    """Plain version: one indexed write per buffer, of the writing replicas'
    rows only (a boolean selection, so it reads the mask on the host)."""
    P, bk, hd = k_pool.shape
    write = (ok == 1) & (page >= 0) & (page < P) & (off >= 0) & (off < bk)
    rows = (page.long() * bk + off.long())[write]
    k_pool.view(P * bk, hd)[rows] = tok_k[write]
    v_pool.view(P * bk, hd)[rows] = tok_v[write]
    ks_pool.view(P * bk)[rows] = tok_ks[write]
    vs_pool.view(P * bk)[rows] = tok_vs[write]


def paged_append_kernel(page, off, ok, tok_k, tok_v, tok_ks, tok_vs, k_pool,
                        v_pool, ks_pool, vs_pool) -> None:
    """In place: ``k_pool[page[r], off[r]] = tok_k[r]`` (and ``v``, and the
    two scales) for every writing replica. ``page / off / ok i32[R]``,
    tokens ``[R, hd]`` in the pool dtype, pools ``[P_alloc, bk, hd]``,
    token scales ``f32[R]``, pool scales ``f32[P_alloc, bk]``."""
    _check(page, off, ok, tok_k, tok_v, tok_ks, tok_vs, k_pool, v_pool,
           ks_pool, vs_pool)
    if not k_pool.is_cuda:
        paged_append_plain(page, off, ok, tok_k, tok_v, tok_ks, tok_vs,
                           k_pool, v_pool, ks_pool, vs_pool)
        return
    dev, dt = k_pool.device, k_pool.dtype
    check_operands("paged_append", dev, page=(page, torch.int32),
                   off=(off, torch.int32), ok=(ok, torch.int32),
                   tok_k=(tok_k, dt), tok_v=(tok_v, dt),
                   tok_ks=(tok_ks, torch.float32),
                   tok_vs=(tok_vs, torch.float32), k_pool=(k_pool, dt),
                   v_pool=(v_pool, dt), ks_pool=(ks_pool, torch.float32),
                   vs_pool=(vs_pool, torch.float32))
    P, bk, hd = k_pool.shape
    R = page.shape[0]
    if R == 0:
        return
    row_bytes = hd * k_pool.element_size()
    words = int(row_bytes % 4 == 0 and all(
        t.data_ptr() % 4 == 0 for t in (tok_k, tok_v, k_pool, v_pool)))
    err = library().paged_append(
        page.data_ptr(), off.data_ptr(), ok.data_ptr(), tok_k.data_ptr(),
        tok_v.data_ptr(), tok_ks.data_ptr(), tok_vs.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), ks_pool.data_ptr(),
        vs_pool.data_ptr(), R, P, bk, row_bytes, words,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "paged_append")
    paged_append_kernel.launches += 1


paged_append_kernel.launches = 0
