"""The port's decode ops (``sputnik_tpu_torch.ops.decode``) against the JAX
package's ``sputnik_tpu.ops.decode``, on the CPU.

The port runs its kernels' plain versions; JAX runs its XLA oracle
(``set_backend("xla")``) and its Pallas kernels in interpret mode
(``set_backend("pallas")``). Inputs come from seeded numpy. JAX's cache is
``[R_kv, s_max, hd_pad]`` (128 lanes); the port's ``[R_kv, s_max, hd]``, so
JAX's first ``hd`` lanes are compared.

Tolerances: cache bytes, scales, lengths and block tables exactly equal;
decode attention: fp32 and bf16 caches against the oracle 1e-5; int8
against the interpret kernel 1e-4 and against the oracle at JAX's rtol
5e-2 / atol 1e-2. bf16 against the interpret kernel: rtol 2e-2 (JAX's)
with atol 2e-3, not JAX's 2e-4. JAX's kernel rounds ``q`` and ``p * vs``
to bf16 for a bf16 cache (its MXU input formats) and the port computes in
f32, as JAX's oracle does; on these O(1) outputs the two differ by up to
7.3e-4, on elements near 0, where JAX's 2e-4 (set for f32 caches) cannot
hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sputnik_tpu as st
from sputnik_tpu.ops import decode as JD
from sputnik_tpu_torch.ops import decode as TD

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _backend(name, fn):
    st.set_backend(name)
    try:
        return fn()
    finally:
        st.set_backend("auto")


def _np(x):
    """A JAX or torch array as numpy (bf16 through f32, exactly)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_same_cache(jc, tc, hd):
    for f in ("k", "v"):
        np.testing.assert_array_equal(_np(getattr(tc, f)),
                                      _np(getattr(jc, f))[..., :hd],
                                      err_msg=f)
    for f in ("k_scale", "v_scale", "kv_len"):
        np.testing.assert_array_equal(_np(getattr(tc, f)),
                                      _np(getattr(jc, f)), err_msg=f)


@pytest.mark.parametrize("lens,s_max,bk,win,sinks", [
    ([0, 1, 8, 9, 63, 64], 64, 8, 2, 1),       # empty, first block, capacity
    ([5, 30, 100, 128], 128, 32, 1, 1),
    ([0, 17, 40, 96], 96, 8, 3, 0),            # no sinks
    ([1, 2, 7, 50], 64, 16, 4, 2),             # window inside the sinks
    ([3, 64, 200, 256], 256, 32, 8, 0),        # full causal (window = nb)
])
def test_block_table_matches_jax(lens, s_max, bk, win, sinks):
    kv_len = np.asarray(lens, np.int32)
    jt, jv = JD.decode_block_table(jnp.asarray(kv_len), s_max=s_max, bk=bk,
                                   window_blocks=win, sink_blocks=sinks)
    tt, tv = TD.decode_block_table(torch.from_numpy(kv_len), s_max=s_max,
                                   bk=bk, window_blocks=win,
                                   sink_blocks=sinks)
    assert tt.dtype == tv.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_append_paths_match_jax(dtype):
    """prefill_kv (ragged lengths), the ragged append through B21 (JAX:
    its Pallas kernel in interpret mode; a frozen and a full slot stay
    bit-identical), the uniform ``pos=`` append up to and past capacity,
    and append_kv_seq (fitting, then all or nothing): every field equal."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    R, s_max, hd, T = 4, 128, 24, 128
    ks = rng.randn(R, T, hd).astype(np.float32)
    vs = rng.randn(R, T, hd).astype(np.float32) * 3
    lens = np.array([3, 40, 128, 127], np.int32)
    jc = JD.prefill_kv(JD.init_kv_cache(R, s_max, hd, dtype=jdt),
                       jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(lens))
    tc = TD.prefill_kv(TD.init_kv_cache(R, s_max, hd, dtype=tdt),
                       torch.from_numpy(ks), torch.from_numpy(vs),
                       torch.from_numpy(lens))
    _assert_same_cache(jc, tc, hd)
    if dtype == "int8":   # pad tokens were zeroed: their scale is the floor
        assert float(tc.k_scale[0, 3]) == np.float32(1e-30) / np.float32(127)

    active = np.array([1, 0, 1, 1], np.int32)
    for step in range(2):
        kn = rng.randn(R, hd).astype(np.float32)
        vn = rng.randn(R, hd).astype(np.float32)
        before = tc.clone()
        jc = _backend("pallas", lambda: JD.append_kv(
            jc, jnp.asarray(kn), jnp.asarray(vn),
            active=jnp.asarray(active)))
        tc = TD.append_kv(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                          active=torch.from_numpy(active))
        _assert_same_cache(jc, tc, hd)
        for r in (1, 2):   # frozen, full: bit-identical
            for f in ("k", "v", "k_scale", "v_scale"):
                assert torch.equal(getattr(tc, f)[r], getattr(before, f)[r])
        assert tc.kv_len.tolist() == [4 + step, 40, 128, 128]

    # uniform pos= path from a fresh prompt, through capacity
    R2, s2 = 2, 16
    kp = rng.randn(R2, 13, hd).astype(np.float32)
    jc = JD.prefill_kv(JD.init_kv_cache(R2, s2, hd, dtype=jdt),
                       jnp.asarray(kp), jnp.asarray(kp))
    tc = TD.prefill_kv(TD.init_kv_cache(R2, s2, hd, dtype=tdt),
                       torch.from_numpy(kp), torch.from_numpy(kp))
    for _ in range(5):          # 13 -> 16 (full), then two writes past it
        kn = rng.randn(R2, hd).astype(np.float32)
        vn = rng.randn(R2, hd).astype(np.float32)
        jc = JD.append_kv(jc, jnp.asarray(kn), jnp.asarray(vn),
                          pos=jc.kv_len[0])
        tc = TD.append_kv(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                          pos=tc.kv_len[0])
        _assert_same_cache(jc, tc, hd)
    assert tc.kv_len.tolist() == [16, 16]

    # append_kv_seq: a fitting draft, then one that does not fit
    kp = rng.randn(R2, 9, hd).astype(np.float32)
    jc = JD.prefill_kv(JD.init_kv_cache(R2, s2, hd, dtype=jdt),
                       jnp.asarray(kp), jnp.asarray(kp))
    tc = TD.prefill_kv(TD.init_kv_cache(R2, s2, hd, dtype=tdt),
                       torch.from_numpy(kp), torch.from_numpy(kp))
    for q in (4, 4):            # 9 -> 13; 13 + 4 > 16: nothing written
        kn = rng.randn(R2, q, hd).astype(np.float32)
        before = tc.clone()
        jc = JD.append_kv_seq(jc, jnp.asarray(kn), jnp.asarray(kn),
                              jc.kv_len[0])
        tc = TD.append_kv_seq(tc, torch.from_numpy(kn), torch.from_numpy(kn),
                              tc.kv_len[0])
        _assert_same_cache(jc, tc, hd)
    assert tc.kv_len.tolist() == [13, 13]
    assert torch.equal(tc.k, before.k)


def test_ragged_append_plain_matches_jax_interpret_kernel():
    """B21's plain version against the JAX Pallas kernel (interpret), at
    positions crossing its 32-row blocks and 128-lane scale rows; only the
    writing replicas change."""
    from sputnik_tpu.ops.pallas.ragged_append import ragged_append_kernel
    from sputnik_tpu_torch.ops.kernels.ragged_append import (
        ragged_append_plain as t_kernel)

    rng = np.random.RandomState(1)
    R, s_max, hd = 6, 256, 128
    pos = np.array([0, 31, 32, 127, 255, 256], np.int32)
    ok = np.array([1, 1, 0, 1, 1, 1], np.int32)
    k = rng.randn(R, s_max, hd).astype(np.float32)
    v = rng.randn(R, s_max, hd).astype(np.float32)
    ksc = rng.rand(R, s_max).astype(np.float32)
    vsc = rng.rand(R, s_max).astype(np.float32)
    tk = rng.randn(R, hd).astype(np.float32)
    tv = rng.randn(R, hd).astype(np.float32)
    tks = rng.rand(R).astype(np.float32)
    tvs = rng.rand(R).astype(np.float32)
    want = ragged_append_kernel(
        jnp.asarray(pos), jnp.asarray(ok), jnp.asarray(tk), jnp.asarray(tv),
        jnp.broadcast_to(jnp.asarray(tks)[:, None], (R, 128)),
        jnp.broadcast_to(jnp.asarray(tvs)[:, None], (R, 128)),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(ksc), jnp.asarray(vsc),
        interpret=True)
    got = [torch.from_numpy(a.copy()) for a in (k, v, ksc, vsc)]
    t_kernel(torch.from_numpy(pos), torch.from_numpy(ok),
             torch.from_numpy(tk), torch.from_numpy(tv),
             torch.from_numpy(tks), torch.from_numpy(tvs), *got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    changed = (got[0].numpy() != k).any(axis=(1, 2))
    assert changed.tolist() == [True, True, False, True, True, False]


def test_insert_kv_slot_matches_jax_and_validates():
    rng = np.random.RandomState(2)
    kvh, slots, s_max, hd = 2, 3, 32, 16
    kb = rng.randn(kvh * slots, 20, hd).astype(np.float32)
    jc = JD.prefill_kv(JD.init_kv_cache(kvh * slots, s_max, hd, jnp.int8),
                       jnp.asarray(kb), jnp.asarray(kb))
    tc = TD.prefill_kv(TD.init_kv_cache(kvh * slots, s_max, hd, torch.int8),
                       torch.from_numpy(kb), torch.from_numpy(kb))
    ksrc = rng.randn(kvh, 7, hd).astype(np.float32)
    jsrc = JD.prefill_kv(JD.init_kv_cache(kvh, 16, hd, jnp.int8),
                         jnp.asarray(ksrc), jnp.asarray(ksrc))
    tsrc = TD.prefill_kv(TD.init_kv_cache(kvh, 16, hd, torch.int8),
                         torch.from_numpy(ksrc), torch.from_numpy(ksrc))
    jc = JD.insert_kv_slot(jc, jsrc, 1, kv_heads=kvh)
    tc = TD.insert_kv_slot(tc, tsrc, 1, kv_heads=kvh)
    _assert_same_cache(jc, tc, hd)
    assert tc.kv_len.tolist() == [20, 20, 7, 7, 20, 20]
    tc = TD.insert_kv_slot(tc, tsrc, torch.tensor(2), kv_heads=kvh)
    assert tc.kv_len.tolist() == [20, 20, 7, 7, 7, 7]

    bad = [(TD.init_kv_cache(kvh, 16, hd, torch.float32), 0, "dtype"),
           (TD.init_kv_cache(kvh, 16, hd + 1, torch.int8), 0, "hd"),
           (TD.init_kv_cache(kvh + 1, 16, hd, torch.int8), 0, "replicas"),
           (TD.init_kv_cache(kvh, 64, hd, torch.int8), 0, "s_max"),
           (tsrc, 3, "out of range")]
    for src, slot, msg in bad:
        with pytest.raises(ValueError, match=msg):
            TD.insert_kv_slot(tc, src, slot, kv_heads=kvh)


def _attention_case(dtype, qlen, group, bk, hd=32):
    """Caches filled by prefill_kv on both sides (same numpy tokens), one
    replica empty; tables from decode_block_table with sinks + window, per
    KV replica (the op expands them for group > 1)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(10 * qlen + group + bk)
    R_kv, s_max = 3, 96
    lens = np.array([77, 0, 40], np.int32)
    ks = rng.randn(R_kv, s_max, hd).astype(np.float32)
    vs = rng.randn(R_kv, s_max, hd).astype(np.float32)
    q = rng.randn(R_kv * group, qlen, hd).astype(np.float32)
    jc = JD.prefill_kv(JD.init_kv_cache(R_kv, s_max, hd, jdt),
                       jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(lens))
    tc = TD.prefill_kv(TD.init_kv_cache(R_kv, s_max, hd, tdt),
                       torch.from_numpy(ks), torch.from_numpy(vs),
                       torch.from_numpy(lens))
    kw = dict(s_max=s_max, bk=bk, window_blocks=2, sink_blocks=1)
    jt, jv = JD.decode_block_table(jc.kv_len, **kw)
    tt, tv = TD.decode_block_table(tc.kv_len, **kw)
    dkw = dict(bk=bk, qlen=qlen, group=group)

    def jax_out(backend):   # traced under the backend it names
        fn = jax.jit(lambda q_, c_, t_, v_: JD.decode_attention(
            q_, c_, t_, v_, **dkw))
        return np.asarray(_backend(backend, lambda: fn(jnp.asarray(q), jc,
                                                       jt, jv)))

    got = TD.decode_attention(torch.from_numpy(q), tc, tt, tv, **dkw).numpy()
    assert got.shape == (R_kv * group, qlen, hd)
    assert np.all(got[group:2 * group] == 0)   # the empty replica: exact 0
    return got, jax_out


@pytest.mark.parametrize("qlen,group,bk", [(1, 1, 8), (4, 2, 32), (1, 2, 8),
                                           (4, 1, 32), (1, 4, 8)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_attention_matches_jax(dtype, qlen, group, bk):
    got, jax_out = _attention_case(dtype, qlen, group, bk)
    oracle = jax_out("xla")
    if dtype == "int8":
        np.testing.assert_allclose(got, jax_out("pallas"), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got, oracle, rtol=5e-2, atol=1e-2)
        return
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    if dtype == "bf16":
        np.testing.assert_allclose(got, jax_out("pallas"), rtol=2e-2,
                                   atol=2e-3)


def test_int8_oracle_scales_go_through_div127(monkeypatch):
    """The int8 oracle's two scale sites (q's, and each table slot's p *
    v_scale) divide through ``div127``, the true divide on every device
    (a Python divisor becomes a reciprocal multiply on a CUDA tensor): one
    call for q and one a slot, the output unchanged."""
    from sputnik_tpu_torch.ops.kernels import decode_attention as da

    got, _ = _attention_case("int8", 1, 1, 8)
    calls, div127 = [], da.div127

    def counted(x):
        calls.append(tuple(x.shape))
        return div127(x)

    monkeypatch.setattr(da, "div127", counted)
    again, _ = _attention_case("int8", 1, 1, 8)
    tbl, _ = TD.decode_block_table(torch.tensor([77, 0, 40], dtype=torch.int32),
                                   s_max=96, bk=8, window_blocks=2,
                                   sink_blocks=1)
    assert calls == [(3, 1, 1)] * (1 + tbl.shape[1])
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_attention_at_head_dim_256_matches_jax(dtype):
    """C2: ``decode_attention_kernel`` runs hd = 256 on the CPU (its plain
    path has no head-dim limit; the card's is 256), as JAX's decode does,
    at test_decode_attention_matches_jax's tolerances."""
    got, jax_out = _attention_case(dtype, 2, 2, 32, hd=256)
    oracle = jax_out("xla")
    if dtype == "int8":
        np.testing.assert_allclose(got, jax_out("pallas"), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got, oracle, rtol=5e-2, atol=1e-2)
        return
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    if dtype == "bf16":
        np.testing.assert_allclose(got, jax_out("pallas"), rtol=2e-2,
                                   atol=2e-3)


def test_decoder_at_head_dim_256_matches_jax():
    """C2 through the serving layer: a one-layer SparseDecoder with two
    heads of 256 prefills and takes two decode steps as JAX's does
    (activations 1e-4, the cached K equal to 1e-4, lengths equal)."""
    from sputnik_tpu.models import SparseLM as JLM
    from sputnik_tpu.models.serving import SparseDecoder as JDecoder
    from sputnik_tpu_torch import bridge
    from sputnik_tpu_torch.models import SparseDecoder, SparseTransformer

    b, p, h = 1, 8, 512
    cfg = dict(num_layers=1, hidden_size=h, num_heads=2, ffn_hidden_size=64,
               use_residual=True, use_layernorm=True, activation="gelu")
    masks = np.broadcast_to(np.tril(np.ones((p, p), np.float32)),
                            (b, p, p)).copy()
    rng = np.random.RandomState(6)
    x = rng.randn(b, p, h).astype(np.float32)
    jm = JLM.from_masks(masks, vocab_size=11, **cfg).core
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    tm = SparseTransformer.from_masks(masks, **cfg)
    tm.load_state_dict(bridge.transformer_state_dict(params))
    kw = dict(s_max=p + 8, bk=8)
    jd = JDecoder(jm, cache_dtype=jnp.float32, **kw)
    td = SparseDecoder(tm, cache_dtype=torch.float32, **kw)
    assert td.hd == 256
    tol = dict(atol=1e-4, rtol=1e-4)
    jy, jc = jax.jit(jd.prefill)(params, jnp.asarray(x), jd.init_caches(b))
    ty, tc = td.prefill(torch.from_numpy(x), td.init_caches(b))
    step = jax.jit(jd.decode_step)
    for _ in range(2):
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **tol)
        np.testing.assert_array_equal(tc[0].kv_len.numpy(),
                                      np.asarray(jc[0].kv_len))
        n = int(tc[0].kv_len.min())
        np.testing.assert_allclose(tc[0].k[:, :n].numpy(),
                                   np.asarray(jc[0].k)[:, :n, :256], **tol)
        xt = rng.randn(b, 1, h).astype(np.float32)
        jy, jc = step(params, jnp.asarray(xt), jc)
        ty, tc = td.decode_step(torch.from_numpy(xt), tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **tol)


def split_merge_emulated(q, k_rows, v_rows, ks_rows, vs_rows, base, key0,
                         live, kv_len, *, bk, keys, qlen, group, scale):
    """B19 / B20a's split, emulated through the plain state: every slot's
    keys cut into chunks of ``keys`` (the last one shorter), each chunk's
    ``(acc, m, l)`` from ``attend_slots_state`` as a one-slot walk (an int8
    chunk, a whole slot, starting from the running max of the slots before
    it), merged per replica and row in chunk order: ``M = max m``,
    ``sum e^(m - M) acc / max(sum e^(m - M) l, 1e-30)``."""
    from sputnik_tpu_torch.ops.kernels.decode_attention import (
        attend_slots_state)

    rows = (q, k_rows, v_rows, ks_rows, vs_rows)
    kw = dict(qlen=qlen, group=group, scale=scale)
    states = []
    for s in range(base.shape[1]):
        m0 = None
        if k_rows.dtype == torch.int8 and s:
            m0 = attend_slots_state(*rows, base[:, :s], key0[:, :s],
                                    live[:, :s], kv_len, bk=bk, **kw)[1]
        states += [attend_slots_state(
            *rows, base[:, s:s + 1] + lo, key0[:, s:s + 1] + lo,
            live[:, s:s + 1], kv_len, bk=min(keys, bk - lo), m0=m0, **kw)
            for lo in range(0, bk, keys)]
    acc, m, l = (torch.stack(x, 1) for x in zip(*states))
    w = torch.exp(m - m.amax(1, keepdim=True))
    return ((w[..., None] * acc).sum(1)
            / (w * l).sum(1).clamp(min=1e-30)[..., None])


def _contiguous_rows(tbl, valid, cache, bk, group, R):
    """decode_attention_plain's addressing: the rows and positions of each
    slot's keys in the replica's own cache."""
    R_kv, s_max, hd = cache.k.shape
    nb = s_max // bk
    blk = tbl.long()
    key0 = blk.clamp(0, nb - 1) * bk
    rk = (torch.arange(R) // group)[:, None]
    return (cache.k.reshape(-1, hd), cache.v.reshape(-1, hd),
            cache.k_scale.reshape(-1), cache.v_scale.reshape(-1),
            rk * s_max + key0, key0, (valid == 1) & (blk >= 0) & (blk < nb))


@pytest.mark.parametrize("qlen,group", [(1, 1), (4, 4)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_kv_merge_matches_plain_and_jax(dtype, qlen, group):
    """The split-KV algebra of B19 at kv_len 0, 1 and 1088 (bk = 1024, the
    serving block; one replica's window slot invalid): the emulated merge
    over chunks of 96 keys (not dividing bk), 1024 and ``split_keys``' own
    choice (f32 / bf16; a whole block for int8) equals the port's plain
    version and JAX (its XLA oracle; its Pallas kernel in interpret mode),
    and the replica with no key gives exactly 0. Out-of-range block ids
    too, against the plain version alone."""
    from sputnik_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_plain, split_keys)

    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(50 + qlen + group)
    R_kv, s_max, hd, bk = 3, 2048, 16, 1024
    R = R_kv * group
    lens = np.array([1088, 0, 1], np.int32)
    ks, vs = (rng.randn(R_kv, s_max, hd).astype(np.float32)
              for _ in range(2))
    q = rng.randn(R, qlen, hd).astype(np.float32)
    jc = JD.prefill_kv(JD.init_kv_cache(R_kv, s_max, hd, jdt),
                       jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(lens))
    tc = TD.prefill_kv(TD.init_kv_cache(R_kv, s_max, hd, tdt),
                       torch.from_numpy(ks), torch.from_numpy(vs),
                       torch.from_numpy(lens))
    kw = dict(s_max=s_max, bk=bk, window_blocks=2, sink_blocks=0)
    jt, jv = JD.decode_block_table(jc.kv_len, **kw)
    tt, tv = TD.decode_block_table(tc.kv_len, **kw)
    assert tv[2].tolist() == [0, 1]             # kv_len 1: a slot invalid
    tq = torch.from_numpy(q)
    tbl, valid = (t.repeat_interleave(group, 0) for t in (tt, tv))
    plain_kw = dict(bk=bk, qlen=qlen, group=group, scale=hd ** -0.5)
    plain = decode_attention_plain(tbl, valid, tc.kv_len, tq, tc.k, tc.v,
                                   tc.k_scale, tc.v_scale, **plain_kw)
    dkw = dict(bk=bk, qlen=qlen, group=group)
    oracle = np.asarray(_backend("xla", lambda: JD.decode_attention(
        jnp.asarray(q), jc, jt, jv, **dkw)))
    pallas = np.asarray(_backend("pallas", lambda: JD.decode_attention(
        jnp.asarray(q), jc, jt, jv, **dkw)))
    choices = ({bk} if dtype == "int8"
               else {96, bk, split_keys(R, 2, bk, False)})
    assert split_keys(R, 2, bk, dtype == "int8") in choices
    bad = tbl.clone()
    bad[0, 1], bad[-1, 0] = 7, -2                 # ids outside the cache
    for tables in ((tbl, valid), (bad, valid)):
        rows = _contiguous_rows(*tables, tc, bk, group, R)
        ref = decode_attention_plain(tables[0], valid, tc.kv_len, tq, tc.k,
                                     tc.v, tc.k_scale, tc.v_scale, **plain_kw)
        for keys in sorted(choices):
            got = split_merge_emulated(tq, *rows, tc.kv_len, keys=keys,
                                       **plain_kw)
            err = (got - ref).abs().max().item()
            assert err <= 1e-4 * ref.abs().max().item(), (keys, err)
            assert torch.all(got[group:2 * group] == 0)
            if tables[0] is bad:
                continue
            got = got.numpy()
            if dtype == "int8":
                np.testing.assert_allclose(got, pallas, rtol=1e-4,
                                           atol=1e-4)
                np.testing.assert_allclose(got, oracle, rtol=5e-2,
                                           atol=1e-2)
                continue
            np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
            if dtype == "bf16":
                np.testing.assert_allclose(got, pallas, rtol=2e-2,
                                           atol=2e-3)
    assert torch.equal(plain, decode_attention_plain(
        tbl, valid, tc.kv_len, tq, tc.k, tc.v, tc.k_scale, tc.v_scale,
        **plain_kw))


def test_split_keys_spread_the_serving_shape():
    """At the serving shape (R = 32, S = 2, bk = 1024) an fp cache is cut
    at 128 keys, 16 chunks a replica (512 blocks, not 32); an int8 cache
    at its blocks; small problems at 64 keys or the whole (short) block."""
    from sputnik_tpu_torch.ops.kernels.decode_attention import split_keys

    assert split_keys(32, 2, 1024, False) == 128
    assert split_keys(32, 2, 1024, True) == 1024
    assert split_keys(4, 2, 1024, False) == 64
    assert split_keys(4, 3, 8, False) == 8
    assert split_keys(512, 8, 1024, False) == 1024


def test_decode_attention_validates():
    c = TD.init_kv_cache(2, 64, 16, torch.float32)
    tbl = torch.zeros(2, 1, dtype=torch.int32)
    q = torch.zeros(2, 2, 16)
    with pytest.raises(ValueError, match="qlen"):
        TD.decode_attention(q, c, tbl, tbl, bk=32, qlen=1)
    with pytest.raises(ValueError, match="multiple"):
        TD.decode_attention(q, c, tbl, tbl, bk=24, qlen=2)
    with pytest.raises(ValueError, match="group"):
        TD.decode_attention(q[:1], c, tbl, tbl, bk=32, qlen=2)
    with pytest.raises(ValueError, match="not supported"):
        TD.decode_attention(torch.zeros(2, 9, 16), c, tbl, tbl, bk=32,
                            qlen=9)
    big = TD.init_kv_cache(1, 2048, 16, torch.float32)
    with pytest.raises(ValueError, match="1024"):
        TD.decode_attention(torch.zeros(1, 1, 16), big, tbl[:1], tbl[:1],
                            bk=2048)
    with pytest.raises(ValueError, match="active"):
        TD.append_kv(c, torch.zeros(2, 16), torch.zeros(2, 16), pos=0,
                     active=torch.ones(2))


def test_out_of_range_block_id_is_an_invalid_slot():
    rng = np.random.RandomState(4)
    kv = (torch.from_numpy(rng.randn(2, 50, 16).astype(np.float32))
          for _ in range(2))
    c = TD.prefill_kv(TD.init_kv_cache(2, 64, 16, torch.float32), *kv)
    q = torch.from_numpy(rng.randn(2, 1, 16).astype(np.float32))
    tbl = torch.tensor([[0, 1, 7], [-3, 1, 0]], dtype=torch.int32)
    ones = torch.ones_like(tbl)
    got = TD.decode_attention(q, c, tbl, ones, bk=16)
    want = TD.decode_attention(q, c, tbl.clamp(0, 3),
                               torch.tensor([[1, 1, 0], [0, 1, 1]]), bk=16)
    assert torch.equal(got, want)


def test_table_from_topology_row_matches_jax():
    from sputnik_tpu.topology import SparseTopology as JTopology
    from sputnik_tpu_torch import SparseTopology

    mask = np.zeros((4, 1024), np.float32)
    mask[3, [0, 5, 300, 999]] = 1
    for row in (2, 3):
        jb, jv = JD.table_from_topology_row(
            JTopology.from_dense_mask(mask), row, 128)
        tb, tv = TD.table_from_topology_row(
            SparseTopology.from_dense_mask(mask), row, 128)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tv, jv)
