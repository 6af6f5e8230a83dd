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
        ragged_append_kernel as t_kernel)

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


def _attention_case(dtype, qlen, group, bk):
    """Caches filled by prefill_kv on both sides (same numpy tokens), one
    replica empty; tables from decode_block_table with sinks + window, per
    KV replica (the op expands them for group > 1)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(10 * qlen + group + bk)
    R_kv, s_max, hd = 3, 96, 32
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
