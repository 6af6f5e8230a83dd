"""Decode attention over a block KV cache: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``sputnik_tpu/ops/pallas/decode_attention.py:decode_attention_kernel``;
the kernel is ``csrc/decode_attention.cu``. Per query replica ``r``, the
``qlen <= 8`` query rows attend the cache blocks its table names (slots
with ``valid == 0`` skipped), online softmax across the slots, causal per
row against position ``kv_len[r // group] - qlen + row``. A block id
outside ``[0, s_max / bk)`` counts as an invalid slot.

fp32 / bf16 caches compute in fp32 on the upcast cache (the JAX oracle's
algebra: the TPU kernel's bf16 casts of ``q`` and ``p`` are MXU input
formats). int8 caches follow the TPU kernel's int8 algebra, so int8 serving
equals the JAX package's kernel path: ``q`` quantised per row, int8 x int8
products summed exactly, ``p * v_scale`` quantised per row over each whole
``bk`` block to 0..127. Hence ``bk <= MAX_BK``: the kernel holds a block's
scores whole, and the plain version's int products stay exact in fp32
(``127 * 127 * 1024 < 2**24``).
"""

from __future__ import annotations

import torch

from . import check_operands
from ._build import check, library

__all__ = ["decode_attention_kernel", "decode_attention_plain", "QPAD",
           "MAX_BK", "MAX_HD"]

_NEG_LARGE = -1e30
QPAD = 8        # most query rows per replica (speculative verification)
MAX_BK = 1024   # largest KV block
MAX_HD = 128    # largest head dim
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _check(tbl, valid, kv_len, q, k_cache, v_cache, k_scale, v_scale, bk,
           qlen, group):
    R, qn, hd = q.shape
    R_kv, s_max, hd_c = k_cache.shape
    if qn != qlen or not 1 <= qlen <= QPAD:
        raise ValueError(f"q has {qn} rows, qlen {qlen} (at most {QPAD})")
    if hd != hd_c or v_cache.shape != k_cache.shape:
        raise ValueError(f"q {tuple(q.shape)} and caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)} "
                         f"do not match")
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"head dim {hd} outside [1, {MAX_HD}]")
    if not 1 <= bk <= MAX_BK or s_max % bk:
        raise ValueError(f"bk {bk} must be in [1, {MAX_BK}] and divide "
                         f"s_max {s_max}")
    if group < 1 or R != R_kv * group:
        raise ValueError(f"R {R} != R_kv {R_kv} * group {group}")
    if tbl.shape != valid.shape or tbl.dim() != 2 or tbl.shape[0] != R:
        raise ValueError(f"tbl / valid {tuple(tbl.shape)} / "
                         f"{tuple(valid.shape)} must be [R={R}, S]")
    if k_scale.shape != (R_kv, s_max) or v_scale.shape != (R_kv, s_max):
        raise ValueError("scales must be [R_kv, s_max]")
    if kv_len.shape != (R_kv,):
        raise ValueError(f"kv_len {tuple(kv_len.shape)} != ({R_kv},)")
    if k_cache.dtype not in _DTYPES or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"cache dtype {k_cache.dtype} / {v_cache.dtype}: "
                        f"expected one of {list(_DTYPES)}")


def decode_attention_plain(tbl, valid, kv_len, q, k_cache, v_cache, k_scale,
                           v_scale, *, bk: int, qlen: int, group: int,
                           scale: float):
    """Plain version: the kernel's slot-by-slot online softmax, vectorised
    over replicas, one step per table slot."""
    R, _, hd = q.shape
    S = tbl.shape[1]
    dev = q.device
    rk = (torch.arange(R, device=dev) // group)[:, None]        # [R, 1]
    int8 = k_cache.dtype == torch.int8
    qv = q.float() * scale
    if int8:
        qs = qv.abs().amax(-1, keepdim=True).clamp(min=1e-30) / 127.0
        qv = torch.clamp(torch.round(qv / qs), -127, 127)
    kin = torch.arange(bk, device=dev)
    qpos = (kv_len.long()[rk[:, 0]][:, None] - qlen
            + torch.arange(qlen, device=dev)[None])             # [R, qlen]
    m = q.new_full((R, qlen), _NEG_LARGE, dtype=torch.float32)
    l = torch.zeros_like(m)
    acc = torch.zeros((R, qlen, hd), device=dev, dtype=torch.float32)
    nb = k_cache.shape[1] // bk
    for s in range(S):
        blk = tbl[:, s].long()
        live = ((valid[:, s] == 1) & (blk >= 0) & (blk < nb))[:, None]
        keys = blk.clamp(0, nb - 1)[:, None] * bk + kin[None]  # [R, bk]
        kb = k_cache[rk, keys].float()                          # [R, bk, hd]
        vb = v_cache[rk, keys].float()
        sc = qv @ kb.transpose(1, 2)                            # [R, qlen, bk]
        sc = (sc * qs if int8 else sc) * k_scale[rk, keys][:, None]
        sc = torch.where(keys[:, None] <= qpos[..., None], sc, _NEG_LARGE)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        p = torch.where(sc <= _NEG_LARGE / 2, 0.0, p)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        pv = p * v_scale[rk, keys][:, None]
        if int8:
            ps = pv.amax(-1, keepdim=True).clamp(min=1e-30) / 127.0
            ctx = (torch.clamp(torch.round(pv / ps), 0, 127) @ vb) * ps
        else:
            ctx = pv @ vb
        acc = torch.where(live[..., None], acc * corr[..., None] + ctx, acc)
        l = torch.where(live, l_new, l)
        m = torch.where(live, m_new, m)
    return acc / l.clamp(min=1e-30)[..., None]


def decode_attention_kernel(tbl, valid, kv_len, q, k_cache, v_cache, k_scale,
                            v_scale, *, bk: int, qlen: int, group: int = 1,
                            scale: float):
    """``q f32[R, qlen, hd]`` (unscaled) against caches ``[R_kv, s_max, hd]``
    (f32 / bf16 / int8) with scales ``f32[R_kv, s_max]``, tables
    ``tbl / valid i32[R, S]`` per query replica and ``kv_len i32[R_kv]``
    -> ``f32[R, qlen, hd]``."""
    _check(tbl, valid, kv_len, q, k_cache, v_cache, k_scale, v_scale, bk,
           qlen, group)
    if not q.is_cuda:
        return decode_attention_plain(tbl, valid, kv_len, q, k_cache,
                                      v_cache, k_scale, v_scale, bk=bk,
                                      qlen=qlen, group=group, scale=scale)
    dev = q.device
    dt = k_cache.dtype
    check_operands("decode_attention", dev, tbl=(tbl, torch.int32),
                   valid=(valid, torch.int32), kv_len=(kv_len, torch.int32),
                   q=(q, torch.float32), k_cache=(k_cache, dt),
                   v_cache=(v_cache, dt), k_scale=(k_scale, torch.float32),
                   v_scale=(v_scale, torch.float32))
    R, _, hd = q.shape
    s_max = k_cache.shape[1]
    out = torch.empty((R, qlen, hd), device=dev, dtype=torch.float32)
    if R == 0:
        return out
    vec = int(hd % 4 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (q, k_cache, v_cache)))
    err = library().decode_attention(
        tbl.data_ptr(), valid.data_ptr(), kv_len.data_ptr(), q.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), R, tbl.shape[1], bk, qlen, group,
        hd, s_max, _DTYPES[dt], vec, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "decode_attention")
    decode_attention_kernel.launches += 1
    return out


decode_attention_kernel.launches = 0
