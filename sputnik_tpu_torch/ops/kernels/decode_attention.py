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

The plain version runs any head dim, as JAX's decode does; the kernel
takes ``hd <= MAX_HD`` (256: a lane of a warp covers four head dims of
each 128-wide group, one group or two), checked only on the card.
"""

from __future__ import annotations

import torch

from . import SMS, check_operands
from ._build import check, library
from .bsr_spmm_int8 import div127

__all__ = ["decode_attention_kernel", "decode_attention_plain",
           "attend_slots_plain", "attend_slots_state", "split_keys",
           "QPAD", "MAX_BK", "MAX_HD", "DTYPES"]

_NEG_LARGE = -1e30
QPAD = 8        # most query rows per replica (speculative verification)
MAX_BK = 1024   # largest KV block
MAX_HD = 256    # largest head dim of the kernel (the plain path: any)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
SPLIT_CTAS = 4 * SMS   # blocks the split aims for: 4 waves of the SMs


def split_keys(R: int, S: int, bk: int, int8: bool) -> int:
    """Keys of one chunk of B19 / B20a's split walk, from host ints: a whole
    ``bk`` block for an int8 cache (its ``p`` scale is per block); else the
    least power of two >= 64 for which the ``R * S * ceil(bk / keys)``
    chunks stay within ``SPLIT_CTAS`` blocks, at most ``bk``."""
    keys = 64
    while keys < bk and R * S * -(-bk // keys) > SPLIT_CTAS:
        keys *= 2
    return bk if int8 else min(keys, bk)


def check_kernel_hd(name: str, hd: int) -> None:
    """The kernel's head-dim limit (the plain path has none)."""
    if hd > MAX_HD:
        raise ValueError(f"{name}: head dim {hd} > {MAX_HD}, the CUDA "
                         f"kernel's limit (the CPU plain path runs any)")


def launch_split(entry, name, ptrs, q, out, *, S, bk, group, extent, dt,
                 vec, scale):
    """Launches B19 / B20a's two passes through the C entry ``entry`` (the
    tables' and operands' pointers ``ptrs``; ``extent``: ``s_max``, or the
    pool's pages) at ``split_keys`` keys a chunk, with the chunks'
    workspace ``f32[R * chunks * qlen * (hd + 2)]`` and the slots' row
    maxima ``f32[R * S * qlen]`` (int8)."""
    R, qlen, hd = q.shape
    check_kernel_hd(name, hd)
    if R > 65535:
        raise ValueError(f"{name}: R {R} > 65535, too many for one grid")
    keys = split_keys(R, S, bk, dt == torch.int8)
    work = torch.empty(R * S * qlen * (-(-bk // keys) * (hd + 2) + 1),
                       device=q.device, dtype=torch.float32)
    err = entry(*ptrs, out.data_ptr(), work.data_ptr(), R, S, bk, keys, qlen,
                group, hd, extent, DTYPES[dt], vec, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    check(err, name)


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
    if hd < 1:
        raise ValueError(f"head dim {hd} < 1")
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
    if k_cache.dtype not in DTYPES or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"cache dtype {k_cache.dtype} / {v_cache.dtype}: "
                        f"expected one of {list(DTYPES)}")


def attend_slots_state(q, k_rows, v_rows, ks_rows, vs_rows, base, key0, live,
                       kv_len, *, bk: int, qlen: int, group: int,
                       scale: float, m0=None):
    """The TPU kernel's slot-by-slot online softmax, vectorised over
    replicas, one step per table slot, over keys addressed as rows: slot
    ``s`` of query replica ``r`` reads rows ``base[r, s] + j`` of
    ``k_rows`` / ``v_rows`` (``[N, hd]``) and ``ks_rows`` / ``vs_rows``
    (``[N]``), at positions ``key0[r, s] + j`` (``j < bk``), where
    ``live[r, s]``. Returns the unnormalised state ``(acc f32[R, qlen, hd],
    m, l f32[R, qlen])``: ``m = -1e30``, ``l = 0``, ``acc = 0`` where no key
    was seen. ``m0 f32[R, qlen]``: the running max before the first slot
    (-1e30), as the kernel's int8 chunks take it from the earlier slots."""
    R, _, hd = q.shape
    S = base.shape[1]
    dev = q.device
    rk = torch.arange(R, device=dev) // group                    # [R]
    int8 = k_rows.dtype == torch.int8
    qv = q.float() * scale
    if int8:
        qs = div127(qv.abs().amax(-1, keepdim=True).clamp(min=1e-30))
        qv = torch.clamp(torch.round(qv / qs), -127, 127)
    kin = torch.arange(bk, device=dev)
    qpos = (kv_len.long()[rk][:, None] - qlen
            + torch.arange(qlen, device=dev)[None])             # [R, qlen]
    m = (q.new_full((R, qlen), _NEG_LARGE, dtype=torch.float32)
         if m0 is None else m0)
    l = torch.zeros_like(m)
    acc = torch.zeros((R, qlen, hd), device=dev, dtype=torch.float32)
    for s in range(S):
        rows = base[:, s, None] + kin[None]                     # [R, bk]
        keys = key0[:, s, None] + kin[None]
        kb = k_rows[rows].float()                               # [R, bk, hd]
        vb = v_rows[rows].float()
        sc = qv @ kb.transpose(1, 2)                            # [R, qlen, bk]
        sc = (sc * qs if int8 else sc) * ks_rows[rows][:, None]
        sc = torch.where(keys[:, None] <= qpos[..., None], sc, _NEG_LARGE)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        p = torch.where(sc <= _NEG_LARGE / 2, 0.0, p)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        pv = p * vs_rows[rows][:, None]
        if int8:
            ps = div127(pv.amax(-1, keepdim=True).clamp(min=1e-30))
            ctx = (torch.clamp(torch.round(pv / ps), 0, 127) @ vb) * ps
        else:
            ctx = pv @ vb
        on = live[:, s, None]
        acc = torch.where(on[..., None], acc * corr[..., None] + ctx, acc)
        l = torch.where(on, l_new, l)
        m = torch.where(on, m_new, m)
    return acc, m, l


def attend_slots_plain(*args, **kw):
    """``attend_slots_state`` normalised, ``acc / max(l, 1e-30)``: the plain
    version of B19 and of B20a (paged), which differ only in ``base`` /
    ``key0``."""
    acc, _, l = attend_slots_state(*args, **kw)
    return acc / l.clamp(min=1e-30)[..., None]


def decode_attention_plain(tbl, valid, kv_len, q, k_cache, v_cache, k_scale,
                           v_scale, *, bk: int, qlen: int, group: int,
                           scale: float):
    """Plain version: the slots' keys are rows ``rk * s_max + blk * bk + j``
    of the replica's own cache, at positions ``blk * bk + j``."""
    R_kv, s_max, hd = k_cache.shape
    nb = s_max // bk
    rk = (torch.arange(q.shape[0], device=q.device) // group)[:, None]
    blk = tbl.long()
    live = (valid == 1) & (blk >= 0) & (blk < nb)
    key0 = blk.clamp(0, nb - 1) * bk
    return attend_slots_plain(
        q, k_cache.reshape(-1, hd), v_cache.reshape(-1, hd),
        k_scale.reshape(-1), v_scale.reshape(-1), rk * s_max + key0, key0,
        live, kv_len, bk=bk, qlen=qlen, group=group, scale=scale)


def decode_attention_kernel(tbl, valid, kv_len, q, k_cache, v_cache, k_scale,
                            v_scale, *, bk: int, qlen: int, group: int = 1,
                            scale: float):
    """``q f32[R, qlen, hd]`` (unscaled) against caches ``[R_kv, s_max, hd]``
    (f32 / bf16 / int8) with scales ``f32[R_kv, s_max]``, tables
    ``tbl / valid i32[R, S]`` per query replica and ``kv_len i32[R_kv]``
    -> ``f32[R, qlen, hd]``. Any hd on the CPU; ``hd <= MAX_HD`` (256) on
    the card."""
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
    launch_split(library().decode_attention, "decode_attention",
                 [t.data_ptr() for t in (tbl, valid, kv_len, q, k_cache,
                                         v_cache, k_scale, v_scale)],
                 q, out, S=tbl.shape[1], bk=bk, group=group, extent=s_max,
                 dt=dt, vec=vec, scale=scale)
    decode_attention_kernel.launches += 1
    return out


decode_attention_kernel.launches = 0
