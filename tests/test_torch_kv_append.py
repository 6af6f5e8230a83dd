"""The KV append (B21 ``ops/kernels/ragged_append.py``, B20b
``ops/kernels/paged_append.py``: one launch a layer on the card, their
fused plain versions here) through the port's four append functions
against the JAX package's, on the CPU.

JAX runs its Pallas kernels in interpret mode (``set_backend("pallas")``:
the ragged append where ``s_max % 128 == 0``, the paged append always) and
its ``dynamic_update_slice`` composites elsewhere. Tokens are the split
views of a ``[b, q, heads, 3 * hd]`` projection folded as the decoders
fold them (strided, never copied, for one token), in fp32 or bf16; JAX gets
the same values. Every field (``k``, ``v``, both scales, ``kv_len``) must
be exactly equal: the write rule is a cast or a rounding, with no sum
whose order could differ.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu.ops import decode as JD
from sputnik_tpu.ops import paged as JP
from sputnik_tpu_torch.ops import decode as TD
from sputnik_tpu_torch.ops import paged as TP
from sputnik_tpu_torch.ops.kernels.ragged_append import ragged_append_kernel
from test_torch_decode import DTYPES, _assert_same_cache, _backend, _np
from test_torch_paged import _pair, _same_state

TOK = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
B, HEADS = 2, 3                     # R = 6 replicas


def _proj(rng, hd, q, tok):
    """K and V tokens ``[R, hd]`` (``q == 1``) or ``[R, q, hd]`` as the
    decoder hands them over, and the same values for JAX."""
    jdt, tdt = TOK[tok]
    x = torch.from_numpy(rng.randn(B, q, HEADS, 3 * hd).astype(
        np.float32) * 2).to(tdt)
    out = []
    for part in (x[..., hd:2 * hd], x[..., 2 * hd:]):
        t = part.transpose(1, 2).reshape(B * HEADS, q, hd)
        out.append(t[:, 0] if q == 1 else t)
    if q == 1:
        assert out[0].stride(0) == 3 * hd      # a view of the projection
    return [jnp.asarray(_np(t.contiguous())).astype(jdt) for t in out] + out


def _fields(c):
    return {f: getattr(c, f) for f in ("k", "v", "k_scale", "v_scale")}


def _prefilled(dtype, R, s_max, hd, T, rng, lens=None):
    jdt, tdt = DTYPES[dtype]
    ks = rng.randn(R, T, hd).astype(np.float32)
    vs = rng.randn(R, T, hd).astype(np.float32) * 3
    jl = None if lens is None else jnp.asarray(lens)
    tl = None if lens is None else torch.from_numpy(lens)
    jc = JD.prefill_kv(JD.init_kv_cache(R, s_max, hd, dtype=jdt),
                       jnp.asarray(ks), jnp.asarray(vs), jl)
    tc = TD.prefill_kv(TD.init_kv_cache(R, s_max, hd, dtype=tdt),
                       torch.from_numpy(ks), torch.from_numpy(vs), tl)
    return jc, tc


def _append_keeps_old_len(append, tc):
    """``append(tc)``; the cache passed in keeps its ``kv_len`` tensor and
    values (the new length is a fresh tensor)."""
    old_len, old_vals = tc.kv_len, tc.kv_len.clone()
    new = append(tc)
    assert tc.kv_len is old_len and torch.equal(old_len, old_vals)
    assert new.kv_len is not old_len and new.kv_len.dtype == torch.int32
    return new


@pytest.mark.parametrize("hd", [24, 64])
@pytest.mark.parametrize("tok", sorted(TOK))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_contiguous_appends_match_jax(dtype, tok, hd):
    """append_kv ragged (a frozen slot, a full one, one that fills), uniform
    ``pos=`` (a device scalar and an int, through capacity) and
    append_kv_seq (a draft of 8 that fits, one of 4 that does not, one of 3
    that ends at ``s_max``)."""
    rng = np.random.RandomState(hd)
    R = B * HEADS
    # ragged at s_max 128, where JAX takes its Pallas kernel
    lens = np.array([0, 5, 127, 128, 60, 3], np.int32)
    jc, tc = _prefilled(dtype, R, 128, hd, 128, rng, lens)
    active = np.array([1, 1, 1, 1, 0, 1], np.int32)
    for step in range(2):
        jk, jv, tk, tv = _proj(rng, hd, 1, tok)
        before = tc.clone()
        jc = _backend("pallas", lambda: JD.append_kv(
            jc, jk, jv, active=jnp.asarray(active)))
        tc = _append_keeps_old_len(lambda c: TD.append_kv(
            c, tk, tv, active=torch.from_numpy(active)), tc)
        _assert_same_cache(jc, tc, hd)
        for r in (3, 4) + ((2,) if step else ()):   # full, frozen, filled
            for f, t in _fields(tc).items():
                assert torch.equal(t[r], getattr(before, f)[r]), (r, f)
    assert tc.kv_len.tolist() == [2, 7, 128, 128, 60, 5]

    # uniform: 62 -> 63 -> 64 (full), then two writes past capacity
    jc, tc = _prefilled(dtype, R, 64, hd, 62, rng)
    for i in range(4):
        jk, jv, tk, tv = _proj(rng, hd, 1, tok)
        before = tc.clone()
        pos = tc.kv_len[0] if i % 2 == 0 else int(tc.kv_len[0])
        jc = JD.append_kv(jc, jk, jv, pos=jc.kv_len[0])
        tc = _append_keeps_old_len(
            lambda c: TD.append_kv(c, tk, tv, pos=pos), tc)
        _assert_same_cache(jc, tc, hd)
        if i >= 2:
            for f, t in _fields(tc).items():
                assert torch.equal(t, getattr(before, f)), f
    assert tc.kv_len.tolist() == [64] * R

    # drafts: 53 -> 61; 61 + 4 > 64: nothing written; 61 -> 64
    jc, tc = _prefilled(dtype, R, 64, hd, 53, rng)
    for q in (8, 4, 3):
        jk, jv, tk, tv = _proj(rng, hd, q, tok)
        before = tc.clone()
        jc = JD.append_kv_seq(jc, jk, jv, jc.kv_len[0])
        tc = _append_keeps_old_len(
            lambda c: TD.append_kv_seq(c, tk, tv, c.kv_len[0]), tc)
        _assert_same_cache(jc, tc, hd)
        if q == 4:
            for f, t in _fields(tc).items():
                assert torch.equal(t, getattr(before, f)), f
    assert tc.kv_len.tolist() == [64] * R


@pytest.mark.parametrize("hd", [24, 64])
@pytest.mark.parametrize("tok", sorted(TOK))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_appends_match_jax(dtype, tok, hd):
    """append_paged (a frozen replica, one with no page, one that reaches
    the table's capacity and one already there), then append_paged_seq (a
    draft crossing a page boundary, one with no page for its second block,
    one past the capacity, a frozen one); pool bytes, scales, tables and
    lengths equal JAX's Pallas kernel (interpret)."""
    n_pages, mb = 10, 2
    lens = [0, 125, 128, 37, 255, 256]
    jc, jpool, tc, tpool = _pair(B * HEADS, n_pages, hd, mb, dtype,
                                 lens=lens, seed=hd, fill=True)
    rows = [0, 1, 3, 4]                     # 2 has no page for block 1
    jc = JP.ensure_pages(jc, jpool, 1, replicas=rows)
    tc = TP.ensure_pages(tc, tpool, 1, replicas=rows)
    rng = np.random.RandomState(hd + 1)
    act = np.array([1, 1, 1, 0, 1, 1], np.int32)
    for _ in range(2):
        jk, jv, tk, tv = _proj(rng, hd, 1, tok)
        jc = _backend("pallas", lambda: JP.append_paged(
            jc, jk, jv, active=jnp.asarray(act)))
        tc = _append_keeps_old_len(lambda c: TP.append_paged(
            c, tk, tv, active=torch.from_numpy(act)), tc)
        _same_state(jc, tc, n_pages, hd)
    assert tc.kv_len.tolist() == [2, 127, 128, 37, 256, 256]
    assert not torch.any(tc.k[tc.dump_page] != 0)

    rows = [0, 1, 3]                        # 1 crosses into block 1
    jc = JP.ensure_pages(jc, jpool, 4, replicas=rows)
    tc = TP.ensure_pages(tc, tpool, 4, replicas=rows)
    before = tc.clone()
    act = np.array([1, 1, 1, 0, 1, 1], np.int32)
    jk, jv, tk, tv = _proj(rng, hd, 4, tok)
    jc = _backend("pallas", lambda: JP.append_paged_seq(
        jc, jk, jv, active=jnp.asarray(act)))
    tc = _append_keeps_old_len(lambda c: TP.append_paged_seq(
        c, tk, tv, active=torch.from_numpy(act)), tc)
    _same_state(jc, tc, n_pages, hd)
    assert tc.kv_len.tolist() == [6, 131, 128, 37, 256, 256]
    # the replicas that did not fit wrote nothing anywhere
    changed = set()
    for f, t in _fields(tc).items():
        diff = (t != getattr(before, f)).reshape(t.shape[0] * t.shape[1], -1)
        changed |= set(diff.any(-1).nonzero()[:, 0].tolist())
    tbl = tc.page_table
    want = {int(tbl[r, p // 128]) * 128 + p % 128
            for r, lo in ((0, 2), (1, 127)) for p in range(lo, lo + 4)}
    assert changed == want


@pytest.mark.parametrize("q", [1, 4])
def test_paged_append_page_past_the_pool(q):
    """A table id past the pool (the allocator never hands one out) counts
    as a page for the length, as in JAX's ``_resolve_write``: one replica
    whose only page is such an id, one whose draft crosses into one. JAX's
    write clamps into its dump page; the port stores nothing for those
    tokens (ROADMAP's deliberate differences). Every real page, the
    tables and the lengths equal JAX's."""
    n_pages, mb, hd, bk = 10, 2, 24, 128
    lens = [0, 3, 126, 50, 0, 9]
    jc, jpool, tc, tpool = _pair(B * HEADS, n_pages, hd, mb, lens=lens,
                                 seed=q, fill=True)
    jc = JP.ensure_pages(jc, jpool, 4)
    tc = TP.ensure_pages(tc, tpool, 4)
    tbl = tc.page_table.clone()
    tbl[1, 0] = 1000                     # past both packages' pools
    tbl[2, 1] = 1000                     # 126 + 4 crosses into it
    jc = dataclasses.replace(jc, page_table=jnp.asarray(tbl.numpy()))
    tc = dataclasses.replace(tc, page_table=tbl)
    before = tc.clone()
    jk, jv, tk, tv = _proj(np.random.RandomState(q), hd, q, "f32")
    jfn, tfn = ((JP.append_paged, TP.append_paged) if q == 1 else
                (JP.append_paged_seq, TP.append_paged_seq))
    jc = _backend("pallas", lambda: jfn(jc, jk, jv))
    tc = tfn(tc, tk, tv)
    _same_state(jc, tc, n_pages, hd)
    assert tc.kv_len.tolist() == [n + q for n in lens]
    changed = set()
    for f, t in _fields(tc).items():
        diff = (t != getattr(before, f)).reshape(t.shape[0] * bk, -1)
        changed |= set(diff.any(-1).nonzero()[:, 0].tolist())
    want = {int(tbl[r, p // bk]) * bk + p % bk
            for r, n in enumerate(lens) for p in range(n, n + q)
            if int(tbl[r, p // bk]) < n_pages}
    assert changed == want and len(want) == 5 * q - (q > 2) * 2


HALF = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5]     # scale exactly 1: ties


@pytest.mark.parametrize("route", ["uniform", "ragged", "seq", "paged",
                                   "paged_seq"])
def test_int8_codes_round_half_to_even(route):
    """A token whose codes land on .5 (``x / 1.0``) rounds half to even on
    every route, as JAX does: [127, 0, 2, 2, -0, -2]."""
    hd = len(HALF)
    row = np.asarray(HALF, np.float32)
    kn = np.stack([row, -row])
    q = 2 if route.endswith("seq") else 1
    kq = np.repeat(kn[:, None], q, 1) if q > 1 else kn
    jt, tt = jnp.asarray(kq), torch.from_numpy(kq)
    if route.startswith("paged"):
        jc, jpool, tc, tpool = _pair(2, 4, hd, 2, "int8", lens=[3, 127])
        jc = JP.ensure_pages(jc, jpool, q)
        tc = TP.ensure_pages(tc, tpool, q)
        fn = (JP.append_paged, TP.append_paged) if q == 1 else (
            JP.append_paged_seq, TP.append_paged_seq)
        jc = _backend("pallas", lambda: fn[0](jc, jt, jt))
        tc = fn[1](tc, tt, tt)
        _same_state(jc, tc, 4, hd)
        rows = [tc.k[int(tc.page_table[r, p // 128]), p % 128]
                for r, p in ((0, 3), (1, 127))]
        scales = [tc.k_scale[int(tc.page_table[0, 0]), 3]]
    else:
        s_max = 128
        jc, tc = _prefilled("int8", 2, s_max, hd, 5, np.random.RandomState(0))
        if route == "uniform":
            jc = JD.append_kv(jc, jt, jt, pos=jc.kv_len[0])
            tc = TD.append_kv(tc, tt, tt, pos=tc.kv_len[0])
        elif route == "ragged":
            jc = _backend("pallas", lambda: JD.append_kv(jc, jt, jt))
            tc = TD.append_kv(tc, tt, tt)
        else:
            jc = JD.append_kv_seq(jc, jt, jt, jc.kv_len[0])
            tc = TD.append_kv_seq(tc, tt, tt, tc.kv_len[0])
        _assert_same_cache(jc, tc, hd)
        rows = [tc.k[0, 5], tc.k[1, 5]]
        scales = [tc.k_scale[0, 5]]
    assert float(scales[0]) == 1.0
    assert rows[0].tolist() == [127, 0, 2, 2, 0, -2]
    assert rows[1].tolist() == [-127, 0, -2, -2, 0, 2]


def test_append_routes_refuse_what_they_do_not_write():
    c = TD.init_kv_cache(2, 16, 8, torch.float32)
    t1, t3 = torch.zeros(2, 8), torch.zeros(2, 3, 8)
    args = (c.k, c.v, c.k_scale, c.v_scale, c.kv_len)
    with pytest.raises(ValueError, match="ragged route"):
        ragged_append_kernel(t3, t3, *args, seq=True)
    with pytest.raises(ValueError, match="seq=True"):
        ragged_append_kernel(t3, t3, *args, pos=0)
    with pytest.raises(ValueError, match="active"):
        ragged_append_kernel(t1, t1, *args, pos=0,
                             active=torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="expected"):
        ragged_append_kernel(torch.zeros(3, 8), torch.zeros(3, 8), *args)
    with pytest.raises(TypeError, match="int32"):
        ragged_append_kernel(t1, t1, *args[:4], c.kv_len.long())
