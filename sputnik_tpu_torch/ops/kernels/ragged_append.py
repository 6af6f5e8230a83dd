"""Ragged KV append: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``sputnik_tpu/ops/pallas/ragged_append.py:ragged_append_kernel``;
the kernel is ``csrc/ragged_append.cu``. Each replica writes one token at
its own position, in place, where ``0 <= pos < s_max`` and ``ok == 1``; any
other replica's cache stays bit-identical. ``kv_len`` advances outside.
"""

from __future__ import annotations

import torch

from . import check_operands
from ._build import check, library

__all__ = ["ragged_append_kernel", "ragged_append_plain"]

_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def _check(pos, ok, tok_k, tok_v, tok_ks, tok_vs, k_cache, v_cache,
           ks_cache, vs_cache):
    R, s_max, hd = k_cache.shape
    if k_cache.dtype not in _DTYPES:
        raise TypeError(f"cache dtype {k_cache.dtype}: expected one of "
                        f"{list(_DTYPES)}")
    for name, t, shape in (("v_cache", v_cache, (R, s_max, hd)),
                           ("tok_k", tok_k, (R, hd)), ("tok_v", tok_v, (R, hd)),
                           ("ks_cache", ks_cache, (R, s_max)),
                           ("vs_cache", vs_cache, (R, s_max)),
                           ("tok_ks", tok_ks, (R,)), ("tok_vs", tok_vs, (R,)),
                           ("pos", pos, (R,)), ("ok", ok, (R,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"ragged_append: {name} {tuple(t.shape)} != "
                             f"{shape}")


def ragged_append_plain(pos, ok, tok_k, tok_v, tok_ks, tok_vs, k_cache,
                        v_cache, ks_cache, vs_cache) -> None:
    """Plain version: one indexed write per buffer, the old row written
    back where the replica may not write."""
    R, s_max = ks_cache.shape
    p = pos.long().clamp(0, s_max - 1)
    write = (pos >= 0) & (pos < s_max) & (ok == 1)
    r = torch.arange(R, device=pos.device)
    for buf, tok in ((k_cache, tok_k), (v_cache, tok_v)):
        buf[r, p] = torch.where(write[:, None], tok, buf[r, p])
    for buf, tok in ((ks_cache, tok_ks), (vs_cache, tok_vs)):
        buf[r, p] = torch.where(write, tok, buf[r, p])


def ragged_append_kernel(pos, ok, tok_k, tok_v, tok_ks, tok_vs, k_cache,
                         v_cache, ks_cache, vs_cache) -> None:
    """In place: ``k_cache[r, pos[r]] = tok_k[r]`` (and ``v``, and the two
    scales) for every replica with ``0 <= pos[r] < s_max`` and
    ``ok[r] == 1``. ``pos / ok i32[R]``, tokens ``[R, hd]`` in the cache
    dtype, caches ``[R, s_max, hd]``, token scales ``f32[R]``, cache
    scales ``f32[R, s_max]``."""
    _check(pos, ok, tok_k, tok_v, tok_ks, tok_vs, k_cache, v_cache,
           ks_cache, vs_cache)
    if not k_cache.is_cuda:
        ragged_append_plain(pos, ok, tok_k, tok_v, tok_ks, tok_vs, k_cache,
                            v_cache, ks_cache, vs_cache)
        return
    dev, dt = k_cache.device, k_cache.dtype
    check_operands("ragged_append", dev, pos=(pos, torch.int32),
                   ok=(ok, torch.int32), tok_k=(tok_k, dt), tok_v=(tok_v, dt),
                   tok_ks=(tok_ks, torch.float32),
                   tok_vs=(tok_vs, torch.float32), k_cache=(k_cache, dt),
                   v_cache=(v_cache, dt), ks_cache=(ks_cache, torch.float32),
                   vs_cache=(vs_cache, torch.float32))
    R, s_max, hd = k_cache.shape
    if R == 0:
        return
    row_bytes = hd * k_cache.element_size()
    words = int(row_bytes % 4 == 0 and all(
        t.data_ptr() % 4 == 0 for t in (tok_k, tok_v, k_cache, v_cache)))
    err = library().ragged_append(
        pos.data_ptr(), ok.data_ptr(), tok_k.data_ptr(), tok_v.data_ptr(),
        tok_ks.data_ptr(), tok_vs.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), ks_cache.data_ptr(), vs_cache.data_ptr(), R,
        s_max, row_bytes, words, torch.cuda.current_stream(dev).cuda_stream)
    check(err, "ragged_append")
    ragged_append_kernel.launches += 1


ragged_append_kernel.launches = 0
