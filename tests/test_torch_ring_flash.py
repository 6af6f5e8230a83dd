"""Sequence-parallel ring flash attention of the PyTorch port against the JAX
package, on the CPU.

  * ``RingFlashSpec``'s stacked per-(shard, band) metadata, its
    ``ring_compute_balance`` and the shard / unshard helpers equal JAX's;
  * the ring-band kernels' plain versions (B11a over two carried bands,
    B11b) against JAX's Pallas kernels in interpret mode, on one shard;
  * the carried bands equal one pass of B9 over the shard's whole key
    range (the cross-band merge rescales by exp(m_old - m_new) only), and a
    strictly empty band leaves the carry untouched;
  * ``ring_flash_attention`` forward and dq / dk / dv against
    ``sputnik_tpu.parallel.ring_flash_attention`` on a 4-device CPU mesh,
    natural and zigzag partitions, group 1 (B11b) and 2 (B10b + B10c),
    with a fully masked query row and strictly empty future bands;
  * the specs' and the function's ``ValueError``s.

The JAX tests' small shapes (``tests/test_ring_flash.py``): hd 16, bm 8,
bk 128, ndev 4. Tolerances: outputs atol 1e-4, gradients atol 1e-2 (f32 on
both sides, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu.ops.pallas import flash_sparse as jfs
from sputnik_tpu.parallel import RowPartition as JRowPartition
from sputnik_tpu.parallel.ring_flash import RingFlashSpec as JRingFlashSpec
from sputnik_tpu.parallel.ring_flash import (
    ring_flash_attention as j_ring_flash_attention)
from sputnik_tpu_torch.ops.kernels import flash_sparse as fs
from sputnik_tpu_torch.parallel import (RingFlashSpec, RowPartition,
                                        ring_flash_attention)

NDEV, HD, BM, BK = 4, 16, 8, 128
KEYS = ("block_cols", "nblocks", "mask_slot", "t_src_i", "t_nblocks",
        "t_mask_slot", "t_is_partial", "pmask")


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:NDEV]), ("sp",))


def _mask(s):
    mask = np.tril(np.ones((s, s), np.float32))
    mask[17] = 0.0                       # a fully masked query row
    return mask


def _specs(s, zigzag, mesh=None):
    mask = _mask(s)
    jpart = JRowPartition(st.SparseTopology.from_dense_mask(mask), NDEV,
                          bm=BM, balance=False, zigzag=zigzag)
    part = RowPartition(stt.SparseTopology.from_dense_mask(mask), NDEV,
                        bm=BM, balance=False, zigzag=zigzag)
    return (JRingFlashSpec(jpart, bm=BM, bk=BK, mesh=mesh, axis="sp"),
            RingFlashSpec(part, bm=BM, bk=BK))


@pytest.mark.parametrize("zigzag", [False, True], ids=["natural", "zigzag"])
def test_spec_metadata_and_balance_equal_jax(zigzag):
    jspec, spec = _specs(1024, zigzag)
    for attr in ("mb", "m_pad_loc", "n_pad", "n_loc", "kb_loc", "max_bpr",
                 "max_bpc", "kv_zigzag"):
        assert getattr(spec, attr) == getattr(jspec, attr), attr
    for key in KEYS:
        np.testing.assert_array_equal(getattr(spec, key),
                                      getattr(jspec, key), err_msg=key)
    np.testing.assert_array_equal(spec.is_partial, jspec.is_partial_)
    assert spec.ring_compute_balance() == jspec.ring_compute_balance()
    meta = spec.meta("cpu")
    assert meta["block_cols"].dtype == torch.int32
    np.testing.assert_array_equal(meta["pmask"].numpy(), jspec.pmask)


@pytest.mark.parametrize("zigzag", [False, True], ids=["natural", "zigzag"])
def test_shard_helpers_round_trip_and_equal_jax(zigzag):
    jspec, spec = _specs(1024, zigzag)
    rng = np.random.RandomState(1)
    q = rng.randn(3, 1000, HD).astype(np.float32)
    for shard, unshard in (("shard_queries", "unshard_output"),
                           ("shard_keys", "unshard_kv")):
        got = getattr(spec, shard)(torch.from_numpy(q))
        want = getattr(jspec, shard)(jnp.asarray(q))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = getattr(spec, unshard)(got, 1000)
        np.testing.assert_array_equal(back.numpy(), q)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(getattr(jspec, unshard)(want, 1000)))


def _shard_problem(spec, d, group, seed):
    rng = np.random.RandomState(seed)
    R = 2 * group
    q = rng.randn(R, spec.m_pad_loc, HD).astype(np.float32) * HD ** -0.5
    k, v = (rng.randn(NDEV, R // group, spec.n_loc, HD).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _pad(x, width=128):
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, width - x.shape[-1])])


def _jmeta(jspec, d):
    return [jnp.asarray(getattr(jspec, k)[d]) for k in (
        "block_cols", "nblocks", "mask_slot", "is_partial_", "pmask")]


def _meta(spec, d, band):
    m = spec.meta("cpu")
    return [m[k][d, band] for k in ("block_cols", "nblocks", "mask_slot",
                                    "is_partial", "pmask")]


@pytest.mark.parametrize("group", [1, 2])
def test_band_fwd_plain_matches_pallas_over_two_bands(group):
    jspec, spec = _specs(512, False)
    d = 2                                     # bands 2, then 1: both full
    q, k, v = _shard_problem(spec, d, group, seed=3)
    R, rows = q.shape[:2]
    acc = torch.zeros(R, rows, HD)
    m = torch.full((R, rows), -1e30)
    l = torch.zeros(R, rows)
    st_ = np.zeros((R, rows, 128), np.float32)
    st_[..., 0] = -1e30
    jacc, jst = jnp.zeros((R, rows, 128), jnp.float32), jnp.asarray(st_)
    for t in range(2):
        band = (d - t) % NDEV
        fs.flash_sparse_ring_band_fwd(
            *_meta(spec, d, band), torch.from_numpy(q),
            torch.from_numpy(k[band]), torch.from_numpy(v[band]), acc, m, l,
            max_bpr=spec.max_bpr, group=group)
        jacc, jst = jfs.flash_sparse_ring_band_fwd(
            jnp.asarray([band], jnp.int32), *_jmeta(jspec, d),
            jnp.asarray(_pad(q)), jnp.asarray(_pad(k[band])),
            jnp.asarray(_pad(v[band])), jacc, jst, R=R, mb=spec.mb,
            max_bpr=spec.max_bpr, bm=BM, bk=BK, group=group, interpret=True)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc)[..., :HD],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jst)[..., 0])
    np.testing.assert_allclose(l.numpy(), np.asarray(jst)[..., 1],
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("group", [1, 2])
def test_band_fwd_split_plain_matches_pallas_and_keeps_untouched_rows(group):
    """The plain twin of B11a's split walk (chunks of one slot from the
    identity, then the merge with the carry) fed the carry of the bands
    before, band by band against JAX's ``flash_sparse_ring_band_fwd`` in
    interpret mode at 1e-4; the empty band (a natural causal shard's
    future) leaves every row's carry bit for bit."""
    jspec, spec = _specs(1024, False)
    d = 2                                     # bands 2 (diagonal), 1, 3
    q, k, v = _shard_problem(spec, d, group, seed=8)
    R, rows = q.shape[:2]
    assert spec.max_bpr > 1                   # one-slot chunks cut it
    acc = torch.zeros(R, rows, HD)
    m = torch.full((R, rows), -1e30)
    l = torch.zeros(R, rows)
    st_ = np.zeros((R, rows, 128), np.float32)
    st_[..., 0] = -1e30
    jacc, jst = jnp.zeros((R, rows, 128), jnp.float32), jnp.asarray(st_)
    for band in (2, 1, 3):
        before = [x.clone() for x in (acc, m, l)]
        acc, m, l = fs.flash_sparse_ring_band_fwd_split_plain(
            *_meta(spec, d, band), torch.from_numpy(q),
            torch.from_numpy(k[band]), torch.from_numpy(v[band]), acc, m, l,
            max_bpr=spec.max_bpr, tiles=1, group=group)
        jacc, jst = jfs.flash_sparse_ring_band_fwd(
            jnp.asarray([band], jnp.int32), *_jmeta(jspec, d),
            jnp.asarray(_pad(q)), jnp.asarray(_pad(k[band])),
            jnp.asarray(_pad(v[band])), jacc, jst, R=R, mb=spec.mb,
            max_bpr=spec.max_bpr, bm=BM, bk=BK, group=group, interpret=True)
        np.testing.assert_allclose(acc.numpy(), np.asarray(jacc)[..., :HD],
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jst)[..., 0])
        np.testing.assert_allclose(l.numpy(), np.asarray(jst)[..., 1],
                                   atol=1e-4, rtol=1e-5)
        if not spec.nblocks[d, band].sum():
            for a, b in zip(before, (acc, m, l)):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not spec.nblocks[d, 3].sum()


def _full_forward(spec, d, q, k, v, group=1):
    """Shard ``d``'s carry over all its bands, in ring order."""
    R, rows = q.shape[:2]
    carry = (torch.zeros(R, rows, HD), torch.full((R, rows), -1e30),
             torch.zeros(R, rows))
    for t in range(NDEV):
        band = (d - t) % NDEV
        fs.flash_sparse_ring_band_fwd(
            *_meta(spec, d, band), torch.from_numpy(q),
            torch.from_numpy(k[band]), torch.from_numpy(v[band]), *carry,
            max_bpr=spec.max_bpr, group=group)
    return carry


def test_band_bwd_plain_matches_pallas():
    jspec, spec = _specs(512, False)
    d = 3
    q, k, v = _shard_problem(spec, d, 1, seed=4)
    acc, m, l = _full_forward(spec, d, q, k, v)
    out = acc / l.clamp(min=1e-30)[..., None]
    rng = np.random.RandomState(5)
    g = rng.randn(*q.shape).astype(np.float32)
    D = (torch.from_numpy(g) * out).sum(-1)
    carries = [rng.randn(*x.shape).astype(np.float32) * 0.1
               for x in (q, k[0], k[0])]
    dq, dk, dv = (torch.from_numpy(c.copy()) for c in carries)
    R, rows = q.shape[:2]
    stats = np.zeros((R, rows, 128), np.float32)
    stats[..., 0], stats[..., 1] = m.numpy(), l.numpy()
    dcoef = np.broadcast_to(D.numpy()[..., None], (R, rows, 128))
    kb = spec.n_loc // BK
    jdq = jnp.asarray(_pad(carries[0]))
    jdk, jdv = (jnp.asarray(_pad(c).reshape(R, kb, BK, 128))
                for c in carries[1:])
    for t in range(2):                        # band 3 (full), band 2
        band = (d - t) % NDEV
        fs.flash_sparse_ring_band_bwd(
            *_meta(spec, d, band), torch.from_numpy(q),
            torch.from_numpy(k[band]), torch.from_numpy(v[band]),
            torch.from_numpy(g), m, l, D, dq, dk, dv, max_bpr=spec.max_bpr)
        jdq, jdk, jdv = jfs.flash_sparse_ring_band_bwd(
            jnp.asarray([band], jnp.int32), *_jmeta(jspec, d),
            jnp.asarray(_pad(q)), jnp.asarray(_pad(k[band])),
            jnp.asarray(_pad(v[band])), jnp.asarray(_pad(g)),
            jnp.asarray(stats), jnp.asarray(dcoef), jdq, jdk, jdv, R=R,
            mb=spec.mb, kb=kb, max_bpr=spec.max_bpr, bm=BM, bk=BK,
            interpret=True)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq)[..., :HD],
                               atol=1e-4, rtol=1e-4)
    for got, want in ((dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want).reshape(R, -1, 128)[..., :HD],
            atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("zigzag", [False, True], ids=["natural", "zigzag"])
def test_carried_bands_equal_one_pass_and_empty_bands_keep_the_carry(zigzag):
    """Every shard's carry through its bands, finished, equals B9 over the
    shard's whole key range: the merge across bands is the in-tile
    exp(m_old - m_new) rescale and nothing else. Natural causal shards
    have strictly empty future bands, which must leave the carry
    bit-for-bit as it was."""
    s = 1024
    _, spec = _specs(s, zigzag)
    rng = np.random.RandomState(6)
    k_full, v_full = (rng.randn(2, s, HD).astype(np.float32)
                      for _ in range(2))
    k_sh = spec.shard_keys(torch.from_numpy(k_full)).contiguous().numpy()
    v_sh = spec.shard_keys(torch.from_numpy(v_full)).contiguous().numpy()
    empty = 0
    for d in range(NDEV):
        q = rng.randn(2, spec.m_pad_loc, HD).astype(np.float32)
        acc, m, l = _full_forward(spec, d, q, k_sh, v_sh)
        out = acc / l.clamp(min=1e-30)[..., None]
        view = spec.part.shards[d].block(BM, BK)
        meta = {k: torch.from_numpy(x) for k, x in
                fs.build_flash_meta([view]).items()
                if isinstance(x, np.ndarray)}
        ref, m_ref, l_ref = fs.flash_sparse_attention_fwd_plain(
            meta["block_cols"], meta["nblocks"], meta["mask_slot"],
            meta["is_partial"], meta["pmask"], torch.from_numpy(q),
            torch.from_numpy(k_full), torch.from_numpy(v_full), heads=2,
            max_bpr=view.max_bpr, scale=1.0)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
        np.testing.assert_allclose(l.numpy(), l_ref.numpy(), rtol=1e-5)
        np.testing.assert_array_equal(m.numpy(), m_ref.numpy())
        for band in range(NDEV):
            if spec.nblocks[d, band].sum():
                continue
            empty += 1
            before = [x.clone() for x in (acc, m, l)]
            fs.flash_sparse_ring_band_fwd(
                *_meta(spec, d, band), torch.from_numpy(q),
                torch.from_numpy(k_sh[band]), torch.from_numpy(v_sh[band]),
                acc, m, l, max_bpr=spec.max_bpr)
            for a, b in zip(before, (acc, m, l)):
                assert torch.equal(a, b)
    assert empty == (0 if zigzag else NDEV * (NDEV - 1) // 2)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("zigzag", [False, True], ids=["natural", "zigzag"])
def test_ring_flash_attention_matches_jax(mesh, zigzag, group):
    s = 1024 if zigzag else 512
    jspec, spec = _specs(s, zigzag, mesh)
    rng = np.random.RandomState(7 + group)
    R = 2 * group
    q, k, v = (rng.randn(r, s, HD).astype(np.float32)
               for r in (R, R // group, R // group))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jargs = (jspec.shard_queries(jq), jspec.shard_keys(jk),
             jspec.shard_keys(jv))

    def jloss(a, b, c):
        return jnp.sum(j_ring_flash_attention(jspec, a, b, c,
                                              group=group) ** 2)

    jout = jax.jit(lambda a, b, c: j_ring_flash_attention(
        jspec, a, b, c, group=group))(*jargs)
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*jargs)

    targs = [spec.shard_queries(torch.from_numpy(q)),
             spec.shard_keys(torch.from_numpy(k)),
             spec.shard_keys(torch.from_numpy(v))]
    targs = [x.contiguous().requires_grad_() for x in targs]
    launches = fs.flash_sparse_ring_band_fwd.launches
    out = ring_flash_attention(spec, *targs, group=group)
    assert out.shape == tuple(jout.shape)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-4)
    got = spec.unshard_output(out.detach())
    assert torch.all(got[:, 17] == 0)
    out.square().sum().backward()
    for x, want in zip(targs, jgrads):
        assert x.grad.shape == tuple(want.shape)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want),
                                   atol=1e-2)
    assert torch.all(spec.unshard_output(targs[0].grad)[:, 17] == 0)
    assert fs.flash_sparse_ring_band_fwd.launches == launches  # CPU: plain


def test_ring_validation():
    s = 512
    mask = _mask(s)
    topo = stt.SparseTopology.from_dense_mask(mask)
    with pytest.raises(ValueError, match="natural-order"):
        RingFlashSpec(RowPartition(topo, NDEV, bm=BM), bm=BM, bk=BK)
    with pytest.raises(ValueError, match="whole"):
        RingFlashSpec(RowPartition(stt.SparseTopology.from_dense_mask(
            np.tril(np.ones((320, 320), np.float32))), NDEV, bm=BM,
            balance=False), bm=BM, bk=BK)
    with pytest.raises(ValueError, match="half-chunks"):
        RingFlashSpec(RowPartition(topo, NDEV, bm=BM, zigzag=True), bm=BM,
                      bk=BK)
    part = RowPartition(topo, NDEV, bm=BM, balance=False)
    with pytest.raises(ValueError, match="partition has"):
        RingFlashSpec(part, bm=BM, bk=BK, mesh=stt.parallel.Mesh(
            {"sp": NDEV // 2}))
    spec = RingFlashSpec(part, bm=BM, bk=BK)
    rng = np.random.RandomState(8)
    q = torch.from_numpy(rng.randn(NDEV, 4, s // NDEV, HD).astype(
        np.float32))
    with pytest.raises(ValueError, match="group 3"):
        ring_flash_attention(spec, q, q, q, group=3)
    with pytest.raises(ValueError, match="R // group"):
        ring_flash_attention(spec, q, q, q, group=2)
    with pytest.raises(ValueError, match="pad the sequence"):
        ring_flash_attention(spec, q, q[:, :, :-3], q[:, :, :-3])
    with pytest.raises(ValueError, match="ndev"):
        ring_flash_attention(spec, q[:2], q[:2], q[:2])
    kv = q[0, :2].contiguous()
    with pytest.raises(ValueError, match="group 1 only"):
        fs.flash_sparse_ring_band_bwd(
            *_meta(spec, 0, 0), q[0], kv, kv, q[0], torch.zeros(4, 128),
            torch.ones(4, 128), torch.zeros(4, 128), torch.zeros_like(q[0]),
            torch.zeros_like(kv), torch.zeros_like(kv), max_bpr=spec.max_bpr)
