"""The KV append on the contiguous cache (B21): the CUDA kernel's wrapper,
its plain PyTorch version, and the cache write rule both share.

Replaces ``sputnik_tpu/ops/pallas/ragged_append.py:ragged_append_kernel``
and the composite around it; the kernel is ``csrc/ragged_append.cu``. One
launch per call does the whole append of a layer on every contiguous route:
the cache write rule (``pad_quantize_tokens``), the guarded row writes and
the new lengths, which go to a fresh ``int32[R]`` tensor (the ``kv_len``
passed in is never written: a decoder reads its shared position as a view of
layer 0's lengths, and rollback keeps old caches).

  * uniform (``pos=``, JAX's ``append_kv(pos=)``): one token per replica
    at a shared position; past ``s_max`` the cache stays bit-identical;
    every length becomes ``min(kv_len + 1, s_max)``.
  * speculative (``pos=``, ``seq=True``, JAX's ``append_kv_seq``): ``q``
    tokens at the shared position, all or nothing; ``kv_len + q`` if
    written.
  * ragged (no ``pos``, JAX's ``append_kv`` through its Pallas kernel): one
    token at each replica's own ``kv_len``; a replica with ``kv_len >=
    s_max`` or ``active != 1`` keeps its cache; ``kv_len + active *
    (kv_len < s_max)``.

``ragged_append_plain`` is B21's byte write alone (the JAX Pallas kernel's
function, tested against it); ``ragged_append_fused_plain`` is the whole
append built on it, which CPU tensors run.
"""

from __future__ import annotations

import torch

from ._build import check, library
from .bsr_spmm_int8 import div127

__all__ = ["pad_quantize_tokens", "ragged_append_kernel",
           "ragged_append_fused_plain", "ragged_append_plain"]

# the dtypes the kernel takes, in the order of its dtype codes
TOK_DTYPES = (torch.float32, torch.bfloat16)
CACHE_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def _quantize(x):
    """``f32[..., hd]`` -> ``(int8[..., hd], scale f32[...])``: symmetric
    per-token scale ``max(max|x|, 1e-30) / 127`` (a true divide), round half
    to even, clip to +-127."""
    scale = div127(x.abs().amax(-1).clamp(min=1e-30))
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def pad_quantize_tokens(k_new, v_new, dtype):
    """``(..., hd)`` K/V tokens -> the cache ``dtype`` plus per-token scales
    ``(...,)`` (ones for fp caches): the ONE definition of the cache-write
    rule, shared by every append and prefill path (the kernel computes the
    same in registers)."""
    kf, vf = k_new.float(), v_new.float()
    if dtype == torch.int8:
        kq, ks = _quantize(kf)
        vq, vs = _quantize(vf)
        return kq, vq, ks, vs
    ones = torch.ones(kf.shape[:-1], device=kf.device)
    return kf.to(dtype), vf.to(dtype), ones, ones


def ragged_append_plain(pos, ok, tok_k, tok_v, tok_ks, tok_vs, k_cache,
                        v_cache, ks_cache, vs_cache) -> None:
    """B21's byte write: in place, ``k_cache[r, pos[r]] = tok_k[r]`` (and
    ``v``, and the two scales) for every replica with ``0 <= pos[r] <
    s_max`` and ``ok[r] == 1``; one indexed write per buffer, the old row
    written back where the replica may not write. ``pos / ok i32[R]``,
    tokens ``[R, hd]`` in the cache dtype, token scales ``f32[R]``."""
    R, s_max = ks_cache.shape
    p = pos.long().clamp(0, s_max - 1)
    write = (pos >= 0) & (pos < s_max) & (ok == 1)
    r = torch.arange(R, device=pos.device)
    for buf, tok in ((k_cache, tok_k), (v_cache, tok_v)):
        buf[r, p] = torch.where(write[:, None], tok, buf[r, p])
    for buf, tok in ((ks_cache, tok_ks), (vs_cache, tok_vs)):
        buf[r, p] = torch.where(write, tok, buf[r, p])


def _as_draft(k_new, v_new):
    """``[R, hd]`` or ``[R, q, hd]`` tokens as ``[R, q, hd]`` views."""
    return tuple(t[:, None] if t.dim() == 2 else t for t in (k_new, v_new))


def ragged_append_fused_plain(k_new, v_new, k_cache, v_cache, ks_cache,
                              vs_cache, kv_len, pos=None, active=None,
                              seq=False):
    """Plain version of the whole append (see ``ragged_append_kernel``):
    the write rule, then ``ragged_append_plain`` once per draft token, then
    the new lengths."""
    R, s_max, _ = k_cache.shape
    k3, v3 = _as_draft(k_new, v_new)
    q = k3.shape[1]
    kq, vq, ks, vs = pad_quantize_tokens(k3, v3, k_cache.dtype)
    bufs = (k_cache, v_cache, ks_cache, vs_cache)
    if pos is None:
        ok = (torch.ones((R,), dtype=torch.int32, device=kv_len.device)
              if active is None else active)
        ragged_append_plain(kv_len, ok, kq[:, 0], vq[:, 0], ks[:, 0],
                            vs[:, 0], *bufs)
        return kv_len + ok * (kv_len < s_max).to(torch.int32)
    p_raw = torch.as_tensor(pos, device=kv_len.device).to(
        torch.int32).reshape(1)
    fits = p_raw <= s_max - q
    p = p_raw.clamp(max=s_max - q).clamp(min=0)
    ok = fits.to(torch.int32).expand(R)
    for t in range(q):
        ragged_append_plain((p + t).expand(R), ok, kq[:, t], vq[:, t],
                            ks[:, t], vs[:, t], *bufs)
    if seq:
        return torch.where(fits, kv_len + q, kv_len)
    return torch.clamp(kv_len + 1, max=s_max)


def as_i32(t, dev):
    """``t`` (an ``active`` mask: bool or integer, a tensor or a sequence)
    as a contiguous ``i32`` tensor on ``dev``, without a launch where it is
    one already."""
    if not (isinstance(t, torch.Tensor) and t.dtype == torch.int32
            and t.device == dev and t.is_contiguous()):
        t = torch.as_tensor(t, device=dev).to(torch.int32).contiguous()
    return t


def token_args(name, k_new, v_new, R, hd):
    """The kernel's token operands and what it needs of them, from host
    ints only: ``k``, ``v`` (``[R, hd]``, or ``[R, q, hd]`` drafts) in f32
    or bf16 with a unit last stride (converted or copied only where they
    are not), ``q`` and the element strides ``(k_rs, k_ts, v_rs, v_ts)``."""
    if k_new.dtype != v_new.dtype or k_new.dtype not in TOK_DTYPES:
        k_new, v_new = k_new.float(), v_new.float()
    if k_new.stride(-1) != 1:
        k_new = k_new.contiguous()
    if v_new.stride(-1) != 1:
        v_new = v_new.contiguous()
    shape = k_new.shape
    if (v_new.shape != shape or shape[0] != R or shape[-1] != hd
            or not 2 <= len(shape) <= 3):
        raise ValueError(f"{name}: tokens {tuple(shape)} / "
                         f"{tuple(v_new.shape)}, expected [{R}, {hd}] or "
                         f"[{R}, q, {hd}] each")
    if len(shape) == 2:
        return k_new, v_new, 1, (k_new.stride(0), 0, v_new.stride(0), 0)
    if shape[1] < 1:
        raise ValueError(f"{name}: no tokens to append")
    return k_new, v_new, shape[1], (k_new.stride(0), k_new.stride(1),
                                     v_new.stride(0), v_new.stride(1))


def check_cache(name, k_cache, v_cache, ks_cache, vs_cache, kv_len, rows,
                R):
    """Shapes and dtypes of the cache, its scales and ``kv_len``."""
    if k_cache.dtype not in CACHE_DTYPES or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"{name}: cache dtype {k_cache.dtype}: expected one "
                        f"of {list(CACHE_DTYPES)}")
    if (v_cache.shape != k_cache.shape or ks_cache.shape != rows
            or vs_cache.shape != rows or kv_len.shape != (R,)):
        raise ValueError(f"{name}: cache {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)}, scales "
                         f"{tuple(ks_cache.shape)} / {tuple(vs_cache.shape)}"
                         f", kv_len {tuple(kv_len.shape)}: expected scales "
                         f"{rows}, kv_len {(R,)}")
    if kv_len.dtype != torch.int32 or ks_cache.dtype != torch.float32 or \
            vs_cache.dtype != torch.float32:
        raise TypeError(f"{name}: kv_len must be int32 and the scales "
                        f"float32")


def device_args(name, k, v, strides, bufs, idx, dev):
    """On CUDA: every operand on ``dev``, the cache, its scales and the
    index tensors ``idx`` contiguous. Returns the pointers of the tokens
    and of ``bufs``, and ``vec``: 1 where every lane can move 16 bytes of
    the cache at a time (``hd`` a multiple of ``16 / itemsize``, both
    caches 16-byte aligned, every token row aligned to its pack)."""
    for t in (k, v) + bufs + idx:
        if t.device != dev:
            raise ValueError(f"{name}: an operand is on {t.device}, "
                             f"expected {dev}")
    for t in bufs + idx:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the cache, its scales and the index "
                             f"tensors must be contiguous")
    ptrs = [k.data_ptr(), v.data_ptr()] + [t.data_ptr() for t in bufs]
    n = 16 // bufs[0].element_size()
    es = k.element_size()
    a = min(16, n * es)
    k_rs, k_ts, v_rs, v_ts = strides
    vec = int(bufs[0].shape[-1] % n == 0 and (ptrs[2] | ptrs[3]) % 16 == 0
              and (ptrs[0] | ptrs[1]) % a == 0
              and (k_rs | k_ts | v_rs | v_ts) * es % a == 0)
    return ptrs, vec


def ragged_append_kernel(k_new, v_new, k_cache, v_cache, ks_cache, vs_cache,
                         kv_len, pos=None, active=None, seq=False):
    """One token per replica (``[R, hd]``) or a draft (``[R, q, hd]``,
    ``seq=True``), f32 or bf16, any strides with a unit last one, written
    into ``k_cache`` / ``v_cache`` ``[R, s_max, hd]`` and the scales
    ``f32[R, s_max]`` in place; returns the new ``kv_len`` (a fresh
    ``i32[R]``). ``pos``: the shared position (an int or a 0-d integer
    tensor), or None for the ragged route with ``active`` (``i32[R]`` or
    None). One launch on CUDA; CPU tensors run
    ``ragged_append_fused_plain``."""
    R, s_max, hd = k_cache.shape
    k, v, q, strides = token_args("ragged_append", k_new, v_new, R, hd)
    check_cache("ragged_append", k_cache, v_cache, ks_cache, vs_cache,
                kv_len, (R, s_max), R)
    if pos is None and (seq or q != 1):
        raise ValueError("ragged_append: the ragged route writes one token "
                         "a replica; a draft needs a shared pos")
    if pos is not None and active is not None:
        raise ValueError("ragged_append: active needs the ragged route "
                         "(pos=None); a uniform batch freezes no slots")
    if pos is not None and not seq and q != 1:
        raise ValueError("ragged_append: a draft of q > 1 tokens needs "
                         "seq=True")
    if not k_cache.is_cuda:
        return ragged_append_fused_plain(k, v, k_cache, v_cache, ks_cache,
                                         vs_cache, kv_len, pos, active, seq)
    dev = k_cache.device
    pos_ptr, pos_val, idx = None, 0, (kv_len,)
    if isinstance(pos, torch.Tensor) and pos.device == dev:
        if pos.numel() != 1:
            raise ValueError("ragged_append: pos must be a scalar")
        if pos.dtype != torch.int32:
            pos = pos.to(torch.int32)
        pos_ptr = pos.data_ptr()
    elif pos is not None:
        pos_val = int(pos)
    if active is not None:
        if active.dtype != torch.int32 or active.shape != (R,):
            raise ValueError(f"ragged_append: active must be int32 [{R}]")
        idx += (active,)
    ptrs, vec = device_args("ragged_append", k, v, strides,
                            (k_cache, v_cache, ks_cache, vs_cache), idx, dev)
    new_len = torch.empty((R,), dtype=torch.int32, device=dev)
    if R == 0:
        return new_len
    err = library().ragged_append(
        ptrs[0], ptrs[1], kv_len.data_ptr(), pos_ptr,
        None if active is None else active.data_ptr(), new_len.data_ptr(),
        *ptrs[2:], *strides, TOK_DTYPES.index(k.dtype),
        CACHE_DTYPES.index(k_cache.dtype),
        R, q, hd, s_max, 0 if pos is None else (2 if seq else 1), pos_val,
        vec, torch._C._cuda_getCurrentRawStream(dev.index))
    check(err, "ragged_append")
    ragged_append_kernel.launches += 1
    return new_len


ragged_append_kernel.launches = 0
