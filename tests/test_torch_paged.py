"""The port's paged serving (``ops/paged.py``, ``PagedDecoder``,
``LMServer(n_pages=)``) against the JAX package's, on the CPU.

The port runs its kernels' plain versions; JAX runs its XLA oracle
(``set_backend("xla")``) and its Pallas kernels in interpret mode
(``set_backend("pallas")``). Inputs come from seeded numpy; the flax weights
are carried across by ``bridge``. JAX's pool is ``[round_up(n_pages + 1, 8),
bk, 128]`` (128 lanes, pad to 8); the port's ``[n_pages + 1, bk, hd]``, so
the first ``n_pages`` pages and ``hd`` lanes are compared. Pages are
allocated in a SHUFFLED order (every pool has been filled and freed in a
random order first), so reading a logical block id as an address fails.

Tolerances: allocator state, tables, lengths, refcounts and pool bytes
exactly equal; paged attention 1e-5 of the XLA oracle for f32 / bf16 pools
(the port computes in f32 on the upcast pool, as the oracle does) and 1e-4
of the interpret kernel for f32 / int8 pools; decoder activations 1e-4 of
JAX (two attention implementations) and 1e-6 of the port's own contiguous
decoder; greedy tokens exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sputnik_tpu as st
from sputnik_tpu.models import LMServer as JServer
from sputnik_tpu.models import SparseLM as JLM
from sputnik_tpu.models.serving_paged import PagedDecoder as JPaged
from sputnik_tpu.ops import paged as JP
from sputnik_tpu_torch import bridge
from sputnik_tpu_torch.models import (LMServer, PagedDecoder, SparseDecoder,
                                      SparseLM, SparseTransformer)
from sputnik_tpu_torch.ops import paged as TP
from test_torch_serving import _causal, _perturb

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}
CFG = dict(num_layers=2, hidden_size=32, num_heads=2, ffn_hidden_size=48,
           use_residual=True, use_layernorm=True, activation="gelu")
B, P, BK, V = 2, 128, 128, 97


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


def _shuffle(pools, seed):
    """Fill and free every pool in one random order, so the next
    allocations come out shuffled (the same ids in each pool)."""
    for pool in pools:
        ids = pool.allocate(pool.n_pages)
        pool.free(list(np.random.RandomState(seed).permutation(ids)))


def _same_state(jc, tc, n_pages, hd):
    np.testing.assert_array_equal(tc.page_table.numpy(),
                                  np.asarray(jc.page_table))
    np.testing.assert_array_equal(tc.kv_len.numpy(), np.asarray(jc.kv_len))
    for f in ("k", "v"):
        np.testing.assert_array_equal(
            _np(getattr(tc, f))[:n_pages],
            _np(getattr(jc, f))[:n_pages, :, :hd], err_msg=f)
    for f in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(
            _np(getattr(tc, f))[:n_pages],
            _np(getattr(jc, f))[:n_pages], err_msg=f)


def _pair(R_kv, n_pages, hd, max_blocks, dtype="f32", lens=None, seed=0,
          fill=False):
    """A JAX and a port cache with the same shuffled pools, lengths, tables
    and (``fill``) random pool bytes and scales."""
    jdt, tdt = DTYPES[dtype]
    jc, jpool = JP.init_paged_cache(R_kv, n_pages, BK, hd, max_blocks,
                                    dtype=jdt)
    tc, tpool = TP.init_paged_cache(R_kv, n_pages, BK, hd, max_blocks,
                                    dtype=tdt)
    assert tc.k.shape == (n_pages + 1, BK, hd) and tc.dump_page == n_pages
    _shuffle((jpool, tpool), seed)
    if lens is not None:
        jc = dataclasses.replace(jc, kv_len=jnp.asarray(lens, jnp.int32))
        tc = dataclasses.replace(tc, kv_len=torch.tensor(lens,
                                                         dtype=torch.int32))
        jc = JP.ensure_pages(jc, jpool, 0)
        tc = TP.ensure_pages(tc, tpool, 0)
    if fill:
        rng = np.random.RandomState(seed + 1)
        if dtype == "int8":
            k, v = (rng.randint(-127, 128, (n_pages, BK, hd)).astype(np.int8)
                    for _ in range(2))
        else:
            k, v = (rng.randn(n_pages, BK, hd).astype(np.float32)
                    for _ in range(2))
        lo, span = (0.01, 1 / 64) if dtype == "int8" else (0.5, 1.0)
        ks, vs = (rng.rand(n_pages, BK).astype(np.float32) * span + lo
                  for _ in range(2))
        jc = dataclasses.replace(
            jc, k=jc.k.at[:n_pages, :, :hd].set(jnp.asarray(k, jdt)),
            v=jc.v.at[:n_pages, :, :hd].set(jnp.asarray(v, jdt)),
            k_scale=jc.k_scale.at[:n_pages].set(ks),
            v_scale=jc.v_scale.at[:n_pages].set(vs))
        tc.k[:n_pages] = torch.from_numpy(k).to(tdt)
        tc.v[:n_pages] = torch.from_numpy(v).to(tdt)
        tc.k_scale[:n_pages] = torch.from_numpy(ks)
        tc.v_scale[:n_pages] = torch.from_numpy(vs)
    _same_state(jc, tc, n_pages, hd)
    return jc, jpool, tc, tpool


# -- the host scheduler ------------------------------------------------------


def test_page_pool_matches_jax():
    """Allocation order, free counts, refcounts and every error equal."""
    jp, tp = JP.PagePool(5), TP.PagePool(5)
    for pool in (jp, tp):
        a = pool.allocate(3)
        pool.share(a[:1])
        pool.free([a[1], a[0]])
        b = pool.allocate(2)
        assert a + b == [0, 1, 2, 1, 3]
    np.testing.assert_array_equal(tp._rc, jp._rc)
    assert tp.free_pages == jp.free_pages == 1
    bad = [(lambda p: p.allocate(2), RuntimeError, "exhausted"),
           (lambda p: p.free([2, 2]), ValueError, "double free"),
           (lambda p: p.free([7]), ValueError, "foreign"),
           (lambda p: p.free([-1]), ValueError, "foreign"),
           (lambda p: p.share([4]), ValueError, "unallocated")]
    for fn, exc, msg in bad:
        errs = []
        for pool in (jp, tp):
            with pytest.raises(exc, match=msg) as e:
                fn(pool)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_scheduler_steps_match_jax():
    """ensure_pages (two phases, holes from block 0, capacity), share_prefix
    (full pages shared, a partial tail page copied byte for byte, its
    errors) and free_pages_of: tables, lengths, refcounts and bytes
    equal."""
    n_pages, hd, kvh = 12, 16, 2
    jc, jpool, tc, tpool = _pair(2 * kvh, n_pages, hd, 3,
                                 lens=[300, 300, 0, 0], seed=3, fill=True)
    # the source slot's pages as they are before the fork
    src_pages = tc.page_table[:kvh, :3].numpy().copy()
    before = tc.clone()
    jc = JP.share_prefix(jc, jpool, 0, 1, 200, kv_heads=kvh)
    tc = TP.share_prefix(tc, tpool, 0, 1, 200, kv_heads=kvh)
    _same_state(jc, tc, n_pages, hd)
    np.testing.assert_array_equal(tpool._rc, jpool._rc)
    tbl = tc.page_table.numpy()
    assert (tbl[kvh:, 0] == src_pages[:, 0]).all()       # shared full page
    assert (tbl[kvh:, 1] != src_pages[:, 1]).all()       # copied tail page
    for h in range(kvh):                                 # bytes of the copy
        assert torch.equal(tc.k[tbl[kvh + h, 1]], tc.k[src_pages[h, 1]])
        assert torch.equal(tc.v_scale[tbl[kvh + h, 1]],
                           tc.v_scale[src_pages[h, 1]])

    # the fork appends into its own tail page; the source's pages keep
    # every byte, the shared one included
    rng = np.random.RandomState(4)
    for _ in range(2):
        kn = rng.randn(2 * kvh, hd).astype(np.float32)
        act = np.array([0, 0, 1, 1], np.int32)
        jc = JP.append_paged(jc, jnp.asarray(kn), jnp.asarray(kn),
                             active=jnp.asarray(act))
        tc = TP.append_paged(tc, torch.from_numpy(kn), torch.from_numpy(kn),
                             active=torch.from_numpy(act))
        _same_state(jc, tc, n_pages, hd)
    for p in src_pages.reshape(-1):
        for f in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(getattr(tc, f)[p], getattr(before, f)[p])
    assert tc.kv_len.tolist() == [300, 300, 202, 202]

    # errors: a short source, an unreleased destination, capacity
    for fn in (lambda m, c, p: m.share_prefix(c, p, 1, 0, 250, kv_heads=kvh),
               lambda m, c, p: m.share_prefix(c, p, 0, 1, 100, kv_heads=kvh),
               lambda m, c, p: m.ensure_pages(c, p, 200)):
        for mod, c, p in ((JP, jc, jpool), (TP, tc, tpool)):
            with pytest.raises(ValueError):
                fn(mod, c, p)

    # ensure_pages after admission set kv_len directly fills from block 0
    jc = JP.free_pages_of(jc, jpool, 0, kv_heads=kvh)
    tc = TP.free_pages_of(tc, tpool, 0, kv_heads=kvh)
    _same_state(jc, tc, n_pages, hd)
    np.testing.assert_array_equal(tpool._rc, jpool._rc)
    jc = dataclasses.replace(jc, kv_len=jc.kv_len.at[0].set(130))
    tc = dataclasses.replace(tc, kv_len=tc.kv_len.clone())
    tc.kv_len[0] = 130
    jc, tc = JP.ensure_pages(jc, jpool, 1), TP.ensure_pages(tc, tpool, 1)
    _same_state(jc, tc, n_pages, hd)
    assert (tc.page_table[0, :2] >= 0).all()
    assert tpool.free_pages == jpool.free_pages
    # exhaustion raises before any page is taken
    jc, jpool, tc, tpool = _pair(4, 3, hd, 2)
    for mod, c, p in ((JP, jc, jpool), (TP, tc, tpool)):
        with pytest.raises(RuntimeError, match="exhausted"):
            mod.ensure_pages(c, p, 1)
        assert p.free_pages == 3


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_append_paged_matches_jax(dtype, backend):
    """One token per replica: a page boundary, a frozen replica, one with
    no page for its next block and one at the table's capacity; then a
    draft of 4 (all or nothing per replica). Live pages and scales equal
    JAX's XLA path and its Pallas kernel (interpret) byte for byte."""
    n_pages, hd = 10, 24
    lens = [0, 127, 128, 37, 255, 256]
    jc, jpool, tc, tpool = _pair(6, n_pages, hd, 2, dtype, lens=lens, seed=5)
    # pages for the next token of every replica but 2 (at 128, block 1)
    rows = [0, 1, 3, 4]
    jc, tc = JP.ensure_pages(jc, jpool, 1, replicas=rows), \
        TP.ensure_pages(tc, tpool, 1, replicas=rows)
    rng = np.random.RandomState(6)
    act = np.array([1, 1, 1, 0, 1, 1], np.int32)
    for t in range(2):
        kn = rng.randn(6, hd).astype(np.float32) * 3
        vn = rng.randn(6, hd).astype(np.float32)
        jc = _backend(backend, lambda: JP.append_paged(
            jc, jnp.asarray(kn), jnp.asarray(vn), active=jnp.asarray(act)))
        tc = TP.append_paged(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                             active=torch.from_numpy(act))
        _same_state(jc, tc, n_pages, hd)
    # 1 crossed into block 1 (no page), 2 had none, 3 is frozen, 4 reached
    # the capacity and 5 was there: none of them wrote again
    assert tc.kv_len.tolist() == [2, 128, 128, 37, 256, 256]
    assert not torch.any(tc.k[tc.dump_page] != 0)         # dump never written

    jc, tc = JP.ensure_pages(jc, jpool, 3, replicas=range(4)), \
        TP.ensure_pages(tc, tpool, 3, replicas=range(4))
    kq = rng.randn(6, 4, hd).astype(np.float32)
    jc = _backend(backend, lambda: JP.append_paged_seq(
        jc, jnp.asarray(kq), jnp.asarray(kq)))
    tc = TP.append_paged_seq(tc, torch.from_numpy(kq), torch.from_numpy(kq))
    _same_state(jc, tc, n_pages, hd)
    # the draft crosses into the reserved block 1 for 1 and 2; 4 and 5 are
    # at the capacity: all or nothing
    assert tc.kv_len.tolist() == [6, 132, 132, 41, 256, 256]


def _attention_case(dtype, qlen, group, seed, hd=32):
    n_pages, R_kv = 12, 3
    jc, _, tc, _ = _pair(R_kv, n_pages, hd, 4, dtype, lens=[130, 0, 451],
                         seed=seed, fill=True)
    # the tables: full causal, then a 2-block window with a sink
    tables = []
    for win, sink in ((4, 0), (2, 1)):
        jt = JP.paged_block_table(jc, window_blocks=win, sink_blocks=sink)
        tt = TP.paged_block_table(tc, window_blocks=win, sink_blocks=sink)
        live = tt[2].numpy() == 1
        np.testing.assert_array_equal(tt[2].numpy(), np.asarray(jt[2]))
        for a, b in zip(tt[:2], jt[:2]):      # dump ids differ by design
            np.testing.assert_array_equal(a.numpy()[live],
                                          np.asarray(b)[live])
        assert (tt[0].numpy()[~live] == tc.dump_page).all()
        tables.append((jt, tt))
    q = np.random.RandomState(seed + 9).randn(R_kv * group, qlen, hd).astype(
        np.float32)
    return jc, tc, tables, q


@pytest.mark.parametrize("qlen,group", [(1, 1), (4, 2), (1, 2), (4, 1)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_attention_matches_jax(dtype, qlen, group):
    jc, tc, tables, q = _attention_case(dtype, qlen, group, seed=qlen + group)
    kw = dict(group=group, qlen=qlen)
    for jt, tt in tables:
        got = TP.paged_attention(torch.from_numpy(q), tc, *tt, **kw).numpy()
        assert got.shape == q.shape
        assert np.all(got[group:2 * group] == 0)   # the empty replica
        if dtype != "int8":
            want = _backend("xla", lambda: JP.paged_attention(
                jnp.asarray(q), jc, *jt, **kw))
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                       atol=1e-5)
        if dtype != "bf16":
            want = _backend("pallas", lambda: JP.paged_attention(
                jnp.asarray(q), jc, *jt, **kw))
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_attention_at_head_dim_256_matches_jax(dtype):
    """C2: ``paged_attention_kernel`` runs hd = 256 on the CPU (its plain
    path has no head-dim limit; the card's is 256), against JAX's oracle
    and its Pallas kernel in interpret mode at test_paged_attention_matches_
    jax's tolerances."""
    qlen, group = 2, 2
    jc, tc, tables, q = _attention_case(dtype, qlen, group, seed=11, hd=256)
    kw = dict(group=group, qlen=qlen)
    for jt, tt in tables:
        got = TP.paged_attention(torch.from_numpy(q), tc, *tt, **kw).numpy()
        assert got.shape == (3 * group, qlen, 256)
        assert np.all(got[group:2 * group] == 0)   # the empty replica
        if dtype != "int8":
            want = _backend("xla", lambda: JP.paged_attention(
                jnp.asarray(q), jc, *jt, **kw))
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                       atol=1e-5)
        if dtype != "bf16":
            want = _backend("pallas", lambda: JP.paged_attention(
                jnp.asarray(q), jc, *jt, **kw))
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("qlen,group", [(1, 1), (4, 2)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_kv_merge_matches_plain_and_jax(dtype, qlen, group):
    """B20a's split-KV algebra: the emulated merge over key chunks of 48
    (not dividing the 128-key page), 64 and 128 (f32 / bf16; a whole page
    for int8) equals the port's plain version and JAX (XLA oracle; Pallas
    kernel in interpret mode) on a shuffled pool, the empty replica
    exactly 0; page ids outside the pool against the plain version."""
    from sputnik_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_plain)
    from test_torch_decode import split_merge_emulated

    jc, tc, tables, q = _attention_case(dtype, qlen, group, seed=20 + qlen)
    tq = torch.from_numpy(q)
    P = tc.k.shape[0]
    kw = dict(qlen=qlen, group=group, scale=q.shape[-1] ** -0.5)
    for jt, tt in tables:
        phys, logical, valid = (t.repeat_interleave(group, 0) for t in tt)
        bad = phys.clone()
        bad[0, 0], bad[-1, -1] = P + 3, -1          # outside the pool
        want = {}
        if dtype != "int8":
            want["xla"] = np.asarray(_backend(
                "xla", lambda: JP.paged_attention(
                    jnp.asarray(q), jc, *jt, group=group, qlen=qlen)))
        if dtype != "bf16":
            want["pallas"] = np.asarray(_backend(
                "pallas", lambda: JP.paged_attention(
                    jnp.asarray(q), jc, *jt, group=group, qlen=qlen)))
        for pages in (phys, bad):
            ref = paged_attention_plain(pages, logical, valid, tc.kv_len, tq,
                                        tc.k, tc.v, tc.k_scale, tc.v_scale,
                                        **kw)
            page = pages.long()
            live = (valid == 1) & (page >= 0) & (page < P)
            for keys in ([BK] if dtype == "int8" else [48, 64, BK]):
                got = split_merge_emulated(
                    tq, tc.k.reshape(-1, tc.k.shape[-1]),
                    tc.v.reshape(-1, tc.k.shape[-1]), tc.k_scale.reshape(-1),
                    tc.v_scale.reshape(-1), page.clamp(0, P - 1) * BK,
                    logical.long() * BK, live, tc.kv_len, bk=BK, keys=keys,
                    **kw)
                err = (got - ref).abs().max().item()
                assert err <= 1e-4 * ref.abs().max().item(), (keys, err)
                assert torch.all(got[group:2 * group] == 0)
                if pages is bad:
                    continue
                tol = {"xla": 1e-5, "pallas": 1e-4}
                for name, w in want.items():
                    np.testing.assert_allclose(got.numpy(), w,
                                               rtol=tol[name],
                                               atol=tol[name])


def test_paged_attention_reads_pages_not_blocks():
    """The same tokens in a shuffled pool and in a contiguous cache give the
    same attention: the kernel reads ``phys`` rows at ``logical``
    positions. A page id outside the pool is a skipped slot."""
    from sputnik_tpu_torch.ops import decode as TD

    rng = np.random.RandomState(7)
    R_kv, hd, mb = 2, 16, 3
    lens = [300, 260]
    _, _, tc, _ = _pair(R_kv, 8, hd, mb, lens=lens, seed=8)
    kv = rng.randn(2, R_kv, mb * BK, hd).astype(np.float32)
    dc = TD.prefill_kv(TD.init_kv_cache(R_kv, mb * BK, hd, torch.float32),
                       torch.from_numpy(kv[0]), torch.from_numpy(kv[1]),
                       torch.tensor(lens))
    tc = TP.write_prompt_pages(tc, torch.from_numpy(kv[0]),
                               torch.from_numpy(kv[1]),
                               replica_pages=tc.page_table.numpy(),
                               lengths=torch.tensor(lens))
    phys, logical, valid = TP.paged_block_table(tc, window_blocks=mb)
    assert not torch.equal(phys, logical)
    q = torch.from_numpy(rng.randn(R_kv, 2, hd).astype(np.float32))
    got = TP.paged_attention(q, tc, phys, logical, valid, qlen=2)
    want = TD.decode_attention(q, dc, logical, valid, bk=BK, qlen=2)
    assert torch.equal(got, want)
    bad = phys.clone()
    bad[0, 1] = 99
    bad[1, 0] = -4
    got = TP.paged_attention(q, tc, bad, logical, valid, qlen=2)
    skip = valid.clone()
    skip[0, 1] = skip[1, 0] = 0
    assert torch.equal(got, TP.paged_attention(q, tc, phys, logical, skip,
                                               qlen=2))


def test_paged_ops_validate():
    _, _, tc, _ = _pair(2, 4, 16, 2, lens=[5, 0])
    phys, logical, valid = TP.paged_block_table(tc, window_blocks=2)
    with pytest.raises(ValueError, match="qlen"):
        TP.paged_attention(torch.zeros(2, 2, 16), tc, phys, logical, valid)
    with pytest.raises(ValueError, match="not supported"):
        TP.paged_attention(torch.zeros(2, 9, 16), tc, phys, logical, valid,
                           qlen=9)
    with pytest.raises(ValueError, match="group"):
        TP.paged_attention(torch.zeros(3, 1, 16), tc, phys, logical, valid)
    with pytest.raises(ValueError, match="multiple of 128"):
        TP.init_paged_cache(2, 4, 96, 16, 2)
    with pytest.raises(ValueError, match="draft length"):
        TP.append_paged_seq(tc, torch.zeros(2, 9, 16), torch.zeros(2, 9, 16))
    with pytest.raises(ValueError, match="unallocated"):
        TP.write_prompt_pages(tc, torch.zeros(2, BK, 16),
                              torch.zeros(2, BK, 16),
                              replica_pages=np.array([[0], [-1]]))
    with pytest.raises(ValueError, match="pad to page size"):
        TP.write_prompt_pages(tc, torch.zeros(2, 100, 16),
                              torch.zeros(2, 100, 16),
                              replica_pages=np.array([[0], [1]]))


# -- the decoder and the server ----------------------------------------------


def _decoders(kv_heads, n_pages=3 * B * 2, seed=1):
    cfg = dict(CFG, num_kv_heads=kv_heads)
    x = np.random.RandomState(seed).randn(B, P, 32).astype(np.float32) * 0.5
    jm = JLM.from_masks(_causal(B, P), vocab_size=V, **cfg).core
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                       jnp.asarray(x)), seed)
    tm = SparseTransformer.from_masks(_causal(B, P), **cfg)
    tm.load_state_dict(bridge.transformer_state_dict(params))
    kw = dict(s_max=P + BK, bk=BK)
    return (JPaged(jm, n_pages=n_pages, cache_dtype=jnp.float32, **kw),
            params, PagedDecoder(tm, n_pages=n_pages,
                                 cache_dtype=torch.float32, **kw),
            SparseDecoder(tm, cache_dtype=torch.float32, **kw), x)


def _check_caches(jcs, tcs, n_pages, hd):
    for j, t in zip(jcs, tcs):
        np.testing.assert_array_equal(t.page_table.numpy(),
                                      np.asarray(j.page_table))
        np.testing.assert_array_equal(t.kv_len.numpy(), np.asarray(j.kv_len))
        np.testing.assert_allclose(_np(t.k)[:n_pages],
                                   _np(j.k)[:n_pages, :, :hd], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("kv_heads", [None, 1])
def test_paged_decoder_matches_jax_and_contiguous(kv_heads):
    """prefill, then ragged decode steps with a frozen slot: 1e-4 of JAX's
    PagedDecoder, 1e-6 of the port's contiguous SparseDecoder; tables,
    lengths and pool bytes equal JAX's."""
    jd, params, td, cd, x = _decoders(kv_heads)
    jc, tc = jd.init_caches(B), td.init_caches(B)
    _shuffle(jd.pools + td.pools, 11)
    cc = cd.init_caches(B)
    jy, jc = jd.prefill(params, jnp.asarray(x), jc)
    ty, tc = td.prefill(torch.from_numpy(x), tc)
    cy, cc = cd.prefill(torch.from_numpy(x), cc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(ty, cy, atol=1e-6, rtol=1e-6)
    _check_caches(jc, tc, td.n_pages, td.hd)
    step = jax.jit(jd.decode_step)
    rng = np.random.RandomState(2)
    for act in ([True, True], [True, False], [True, True]):
        xt = rng.randn(B, 1, 32).astype(np.float32) * 0.5
        a = np.array(act)
        jc, tc = jd.reserve(jc, 1), td.reserve(tc, 1)
        jy, jc = step(params, jnp.asarray(xt), jc, active=jnp.asarray(a))
        ty, tc = td.decode_step(torch.from_numpy(xt), tc,
                                active=torch.from_numpy(a))
        cy, cc = cd.decode_step_ragged(torch.from_numpy(xt), cc,
                                       torch.from_numpy(a))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                                   rtol=1e-4)
        torch.testing.assert_close(ty, cy, atol=1e-6, rtol=1e-6)
        _check_caches(jc, tc, td.n_pages, td.hd)
    kvh = td.kv_heads
    assert tc[0].kv_len.tolist() == [P + 3] * kvh + [P + 2] * kvh
    # every layer's table is the same (the step builds one for all)
    for c in tc[1:]:
        assert torch.equal(c.page_table, tc[0].page_table)


def test_paged_decode_multi_and_per_slot_rollback_match_jax():
    """decode_multi where slot 1's draft has no pages (all or nothing: it
    writes nothing and does not advance), then a per-slot rollback and a
    step: equal to JAX's within 1e-4."""
    q = 4
    jd, params, td, _, x = _decoders(None, n_pages=2 * B * 2 + 2, seed=3)
    jc, tc = jd.init_caches(B), td.init_caches(B)
    _, jc = jd.prefill(params, jnp.asarray(x), jc)
    _, tc = td.prefill(torch.from_numpy(x), tc)
    heads = td.kv_heads
    jc = tuple(JP.ensure_pages(c, p, q, replicas=range(heads))
               for c, p in zip(jc, jd.pools))
    tc = tuple(TP.ensure_pages(c, p, q, replicas=range(heads))
               for c, p in zip(tc, td.pools))
    draft = np.random.RandomState(4).randn(B, q, 32).astype(np.float32)
    jy, jc = jd.decode_multi(params, jnp.asarray(draft), jc)
    ty, tc = td.decode_multi(torch.from_numpy(draft), tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    _check_caches(jc, tc, td.n_pages, td.hd)
    assert tc[0].kv_len.tolist() == [P + q] * heads + [P] * heads
    jc = jd.rollback(jc, jnp.asarray([q - 1, 0]))
    tc = td.rollback(tc, torch.tensor([q - 1, 0]))
    assert tc[0].kv_len.tolist() == [P + 1] * heads + [P] * heads
    np.testing.assert_array_equal(tc[1].kv_len.numpy(),
                                  np.asarray(jc[1].kv_len))
    assert td.rollback(tc, 500)[0].kv_len.tolist() == [0] * (B * heads)
    xt = np.random.RandomState(5).randn(B, 1, 32).astype(np.float32)
    jc, tc = jd.reserve(jc, 1), td.reserve(tc, 1)
    jy, jc = jd.decode_step(params, jnp.asarray(xt), jc)
    ty, tc = td.decode_step(torch.from_numpy(xt), tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    _check_caches(jc, tc, td.n_pages, td.hd)


def test_prefix_sharing_decodes_like_an_independent_prefill():
    """Slot 1 admitted with slot 0's prompt through shared pages decodes as
    if it had been prefilled itself; releasing the source keeps the shared
    pages for the fork; releasing both drains the pool."""
    _, _, td, _, x = _decoders(None, n_pages=4 * B * 2)
    x = np.repeat(x[:1], B, 0)
    ref = PagedDecoder(td.model, n_pages=td.n_pages, s_max=td.s_max, bk=BK,
                       cache_dtype=torch.float32)
    rc = ref.init_caches(B)
    _, rc = ref.prefill(torch.from_numpy(x), rc)
    caches = td.init_caches(B)
    _, caches = td.prefill(torch.from_numpy(x), caches,
                           lengths=torch.tensor([P, 0]))
    caches = td.release(caches, 1)
    free = td.free_pages[0]
    caches = td.share_prefix(caches, 0, 1, P)
    assert td.free_pages[0] == free                  # full pages: no copy
    toks = np.random.RandomState(6).randn(2, B, 1, 32).astype(np.float32)
    for t in range(2):
        caches, rc = td.reserve(caches, 1), ref.reserve(rc, 1)
        y, caches = td.decode_step(torch.from_numpy(toks[t]), caches)
        y_ref, rc = ref.decode_step(torch.from_numpy(toks[t]), rc)
        torch.testing.assert_close(y, y_ref, atol=1e-6, rtol=1e-6)
    mid = td.free_pages[0]
    caches = td.release(caches, 0)
    assert td.free_pages[0] == mid + td.kv_heads     # its own decode page
    caches = td.release(caches, 1)
    assert td.free_pages == [td.n_pages] * CFG["num_layers"]


def _lm_pair():
    toks = np.random.RandomState(0).randint(0, V, (B, P))
    jlm = JLM.from_masks(_causal(B, P), vocab_size=V, **CFG)
    params = _perturb(jax.jit(jlm.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(toks)), 1)
    tlm = SparseLM.from_masks(_causal(B, P), vocab_size=V, **CFG)
    tlm.load_state_dict(bridge.lm_state_dict(params))
    return jlm, params, tlm


def test_paged_generate_greedy_tokens_equal_jax():
    """``LMServer(n_pages=).generate``: greedy tokens equal JAX's paged
    server's and the port's contiguous server's (bf16 pool: the same
    arithmetic on the same bytes), plain and with ragged prompt lengths."""
    jlm, params, tlm = _lm_pair()
    prompt = np.random.RandomState(7).randint(0, V, (B, P))
    n_new, n_pages = 6, 3 * B * 2
    js = JServer(jlm, s_max=P + BK, bk=BK, cache_dtype=jnp.float32,
                 n_pages=n_pages)
    ts = LMServer(tlm, s_max=P + BK, bk=BK, cache_dtype=torch.float32,
                  n_pages=n_pages)
    assert isinstance(ts.decoder, PagedDecoder)
    want, jc = js.generate(params, jnp.asarray(prompt), n_new,
                           temperature=0.0)
    got, tc = ts.generate(torch.from_numpy(prompt), n_new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tc[0].kv_len.numpy(),
                                  np.asarray(jc[0].kv_len))
    np.testing.assert_array_equal(tc[0].page_table.numpy(),
                                  np.asarray(jc[0].page_table))
    lens = torch.tensor([P, 77])
    for dtype in (torch.bfloat16, torch.int8):
        paged = LMServer(tlm, s_max=P + BK, bk=BK, cache_dtype=dtype,
                         n_pages=n_pages)
        flat = LMServer(tlm, s_max=P + BK, bk=BK, cache_dtype=dtype)
        pt, _ = paged.generate(torch.from_numpy(prompt), n_new,
                               prompt_lengths=lens)
        ft, _ = flat.generate(torch.from_numpy(prompt), n_new,
                              prompt_lengths=lens)
        assert torch.equal(pt, ft)


def test_serve_paged_example_runs_on_cpu():
    from sputnik_tpu_torch.examples import serve_paged

    out = serve_paged.main(["--small", "--device", "cpu"])
    assert out["live_prefix_pages"] == 2 and out["done_at"] == {1: 3, 0: 4}
