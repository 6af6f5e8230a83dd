"""Paged decode attention: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces ``sputnik_tpu/ops/pallas/paged_attention.py:paged_attention_kernel``;
the kernel is ``csrc/decode_attention.cu`` (entry ``paged_attention``), the
body of B19 (``decode_attention.py``) with another address policy. K/V live
in a page pool ``[P_alloc, bk, hd]`` shared by every replica. Per query
replica ``r`` and table slot ``s``: ``phys[r, s]`` is the pool page whose
rows are read, ``logical[r, s]`` the logical block that places its keys at
positions ``logical * bk + j`` for the causal mask (against
``kv_len[r // group] - qlen + row``), and slots with ``valid == 0`` or a
page id outside ``[0, P_alloc)`` are skipped. The arithmetic, the int8
algebra, the split into key chunks and the limits (``qlen <= 8``,
``bk <= 1024``; on the card ``hd <= 256``, any hd on the CPU) are B19's.
"""

from __future__ import annotations

import torch

from . import check_operands
from ._build import library
from .decode_attention import (DTYPES, MAX_BK, QPAD, attend_slots_plain,
                               launch_split)

__all__ = ["paged_attention_kernel", "paged_attention_plain"]


def _check(phys, logical, valid, kv_len, q, k_pool, v_pool, k_scale, v_scale,
           qlen, group):
    R, qn, hd = q.shape
    P, bk, hd_p = k_pool.shape
    if qn != qlen or not 1 <= qlen <= QPAD:
        raise ValueError(f"q has {qn} rows, qlen {qlen} (at most {QPAD})")
    if hd != hd_p or v_pool.shape != k_pool.shape:
        raise ValueError(f"q {tuple(q.shape)} and pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)} "
                         f"do not match")
    if hd < 1:
        raise ValueError(f"head dim {hd} < 1")
    if not 1 <= bk <= MAX_BK:
        raise ValueError(f"page size bk {bk} outside [1, {MAX_BK}]")
    R_kv = kv_len.shape[0]
    if kv_len.dim() != 1 or group < 1 or R != R_kv * group:
        raise ValueError(f"R {R} != R_kv {R_kv} * group {group}")
    if (phys.shape != logical.shape or phys.shape != valid.shape
            or phys.dim() != 2 or phys.shape[0] != R):
        raise ValueError(f"phys / logical / valid {tuple(phys.shape)} / "
                         f"{tuple(logical.shape)} / {tuple(valid.shape)} "
                         f"must be [R={R}, S]")
    if k_scale.shape != (P, bk) or v_scale.shape != (P, bk):
        raise ValueError(f"scales must be [P_alloc={P}, bk={bk}]")
    if k_pool.dtype not in DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pool dtype {k_pool.dtype} / {v_pool.dtype}: "
                        f"expected one of {list(DTYPES)}")


def paged_attention_plain(phys, logical, valid, kv_len, q, k_pool, v_pool,
                          k_scale, v_scale, *, qlen: int, group: int,
                          scale: float):
    """Plain version: the slots' keys are rows ``page * bk + j`` of the
    pool, at positions ``logical * bk + j``."""
    P, bk, hd = k_pool.shape
    page = phys.long()
    live = (valid == 1) & (page >= 0) & (page < P)
    return attend_slots_plain(
        q, k_pool.reshape(-1, hd), v_pool.reshape(-1, hd),
        k_scale.reshape(-1), v_scale.reshape(-1), page.clamp(0, P - 1) * bk,
        logical.long() * bk, live, kv_len, bk=bk, qlen=qlen, group=group,
        scale=scale)


def paged_attention_kernel(phys, logical, valid, kv_len, q, k_pool, v_pool,
                           k_scale, v_scale, *, qlen: int, group: int = 1,
                           scale: float):
    """``q f32[R, qlen, hd]`` (unscaled) against the pools ``[P_alloc, bk,
    hd]`` (f32 / bf16 / int8) with scales ``f32[P_alloc, bk]``, tables
    ``phys / logical / valid i32[R, S]`` per query replica and ``kv_len
    i32[R_kv]`` -> ``f32[R, qlen, hd]``. Any hd on the CPU; ``hd <= 256``
    on the card."""
    _check(phys, logical, valid, kv_len, q, k_pool, v_pool, k_scale, v_scale,
           qlen, group)
    if not q.is_cuda:
        return paged_attention_plain(phys, logical, valid, kv_len, q, k_pool,
                                     v_pool, k_scale, v_scale, qlen=qlen,
                                     group=group, scale=scale)
    dev = q.device
    dt = k_pool.dtype
    check_operands("paged_attention", dev, phys=(phys, torch.int32),
                   logical=(logical, torch.int32), valid=(valid, torch.int32),
                   kv_len=(kv_len, torch.int32), q=(q, torch.float32),
                   k_pool=(k_pool, dt), v_pool=(v_pool, dt),
                   k_scale=(k_scale, torch.float32),
                   v_scale=(v_scale, torch.float32))
    R, _, hd = q.shape
    P, bk, _ = k_pool.shape
    out = torch.empty((R, qlen, hd), device=dev, dtype=torch.float32)
    if R == 0:
        return out
    vec = int(hd % 4 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (q, k_pool, v_pool)))
    launch_split(library().paged_attention, "paged_attention",
                 [t.data_ptr() for t in (phys, logical, valid, kv_len, q,
                                         k_pool, v_pool, k_scale, v_scale)],
                 q, out, S=phys.shape[1], bk=bk, group=group, extent=P,
                 dt=dt, vec=vec, scale=scale)
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0
