"""Sparse-flash attention backward of the PyTorch port on the CPU (its
autograd Function over the kernels' plain versions) against the JAX package:
the plain backward functions against the JAX kernels ``flash_sparse_bwd_
fused``, ``_dq`` and ``_dkv`` in interpret mode on the same inputs, and
``fused_sparse_attention``'s gradients against ``jax.vjp`` of the JAX op
under its XLA oracle and its Pallas kernels (interpret mode), on both
backward routes. Tolerance atol = rtol = 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu import many_mask as jmm
from sputnik_tpu.ops import batched_panel as jbp
from sputnik_tpu.ops import fused_attention as jfa
from sputnik_tpu.ops.pallas import flash_sparse as jfs
from sputnik_tpu_torch.ops import fused_attention as tfa
from sputnik_tpu_torch.ops.batched_panel import BatchedPanelSpec
from sputnik_tpu_torch.ops.kernels import flash_sparse as tfs

TOL = dict(atol=1e-4, rtol=1e-4)
B, H, S, HD, TILE = 2, 4, 64, 32, 16
MASKED_ROW = 9


def _masks():
    rng = np.random.RandomState(0)
    masks = np.stack([np.tril(np.ones((S, S), np.float32)),
                      (rng.rand(S, S) < 0.35).astype(np.float32)])
    masks[0, MASKED_ROW, :] = 0.0          # fully-masked row
    masks[1, :, 20:36] = 0.0               # key columns no query attends
    return masks


def _specs(masks=None, heads=H):
    masks = _masks() if masks is None else masks
    jspec = jbp.BatchedPanelSpec.from_many_mask(
        jmm.ManyMaskTopology.from_dense_masks(masks), heads=heads, bm=TILE,
        bk=TILE)
    tspec = BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=heads, bm=TILE,
        bk=TILE)
    return jspec, tspec


def _inputs(group, seed=1):
    rng = np.random.RandomState(seed)
    R = B * H
    return (rng.randn(R, S, HD).astype(np.float32),
            rng.randn(R // group, S, HD).astype(np.float32),
            rng.randn(R // group, S, HD).astype(np.float32),
            rng.randn(R, S, HD).astype(np.float32))


@pytest.fixture
def route(request):
    """Force a backward route in BOTH packages by their module constant."""
    old = (jfa._FUSED_BWD_ACC_BYTES, tfa._FUSED_BWD_ACC_BYTES)
    if request.param == "two_kernel":
        jfa._FUSED_BWD_ACC_BYTES = tfa._FUSED_BWD_ACC_BYTES = 0
    try:
        yield request.param
    finally:
        jfa._FUSED_BWD_ACC_BYTES, tfa._FUSED_BWD_ACC_BYTES = old


def test_bwd_meta_equals_jax():
    jspec, tspec = _specs()
    ref = jfs.build_flash_bwd_meta(jspec.views)
    got = tfs.build_flash_bwd_meta(tspec.views)
    assert set(got) == set(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(val),
                                      err_msg=key)
    dev = tspec.flash_bwd_meta("cpu")
    assert tspec.flash_bwd_meta(torch.device("cpu")) is dev
    assert dev["t_src_i"].dtype == torch.int32


@pytest.mark.parametrize("group", [1, 2])
def test_plain_backward_matches_pallas_kernels(group):
    """The three plain backward functions against the JAX kernels in
    interpret mode, fed the same q * scale, k, v, g, m, l and D."""
    jspec, tspec = _specs()
    q, k, v, g = _inputs(group)
    scale = 1.0 / np.sqrt(HD)
    R = B * H
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, m, l = tfa._fused_fwd(tspec, tq, tk, tv, scale, group)
    D = (tg * out).sum(-1)
    m_pad = tspec.m_pad
    stats = np.zeros((R, m_pad, 128), np.float32)
    stats[:, :, 0], stats[:, :, 1] = m.numpy(), l.numpy()
    dcoef = np.zeros((R, m_pad, 128), np.float32)
    dcoef[:, :S] = D.numpy()[:, :, None]
    qs = q * np.float32(scale)
    jm = jfs.build_flash_bwd_meta(jspec.views)
    common = dict(R=R, heads=H, bm=TILE, bk=TILE, group=group, interpret=True)
    jargs = (qs, k, v, g, stats, dcoef)
    row_meta = [jnp.asarray(jm[x]) for x in ("block_cols", "nblocks",
                                             "mask_slot", "is_partial",
                                             "pmask")]
    j_dq, j_dk, j_dv = jfs.flash_sparse_bwd_fused(
        *row_meta, *jargs, mb=jspec.mb, kb=jspec.kb,
        max_bpr=jm["max_bpr"], **common)
    j_dq2 = jfs.flash_sparse_bwd_dq(*row_meta, *jargs, mb=jspec.mb,
                                    max_bpr=jm["max_bpr"], **common)
    j_dk2, j_dv2 = jfs.flash_sparse_bwd_dkv(
        *[jnp.asarray(jm[x]) for x in ("t_src_i", "t_nblocks",
                                       "t_mask_slot", "t_is_partial",
                                       "pmask")],
        *jargs, kb=jspec.kb, max_bpc=jm["max_bpc"], **common)

    def fold(x):     # per query replica, padded -> KV replica [R/g, S, HD]
        x = np.asarray(x).reshape(R // group, group, -1, HD).sum(1)
        return x[:, :S]

    tm = tspec.flash_meta("cpu")
    bm = tspec.flash_bwd_meta("cpu")
    ops = (tq * scale, tk, tv, tg, m, l, D)
    kw = dict(heads=H, scale=1.0, group=group)
    rargs = (tm["block_cols"], tm["nblocks"], tm["mask_slot"],
             tm["is_partial"], tm["pmask"], *ops)
    dq, dk, dv = tfs.flash_sparse_bwd_fused_plain(
        *rargs, max_bpr=tm["max_bpr"], **kw)
    dq2 = tfs.flash_sparse_bwd_dq_plain(*rargs, max_bpr=tm["max_bpr"], **kw)
    dk2, dv2 = tfs.flash_sparse_bwd_dkv_plain(
        bm["t_src_i"], bm["t_nblocks"], bm["t_mask_slot"],
        bm["t_is_partial"], bm["pmask"], *ops, max_bpc=bm["max_bpc"], **kw)
    np.testing.assert_allclose(dq.numpy(), np.asarray(j_dq)[:, :S], **TOL)
    np.testing.assert_allclose(dq2.numpy(), np.asarray(j_dq2)[:, :S], **TOL)
    np.testing.assert_allclose(dk.numpy(), fold(j_dk), **TOL)
    np.testing.assert_allclose(dv.numpy(), fold(j_dv), **TOL)
    np.testing.assert_allclose(dk2.numpy(), fold(j_dk2), **TOL)
    np.testing.assert_allclose(dv2.numpy(), fold(j_dv2), **TOL)
    assert np.all(dq[:H, MASKED_ROW].numpy() == 0.0)
    assert np.all(dq2[:H, MASKED_ROW].numpy() == 0.0)
    # KV replicas of mask 1: keys 20..35 are attended by no query
    assert np.all(dk[H // group:, 20:36].numpy() == 0.0)
    assert np.all(dv2[H // group:, 20:36].numpy() == 0.0)


@pytest.mark.parametrize("tiles", [1, 2, 3])
def test_split_row_walk_sums_to_the_unsplit_one(tiles):
    """The row walk's split plan through its plain twin: each chunk's
    partial dq summed in chunk order (no rescale: p uses the forward's
    final m and l) equals the unsplit walk's dq to f32 rounding and JAX's
    fused kernel (interpret mode) at this file's tolerance; dk / dv equal
    the unsplit walk's; the fully-masked row's dq stays exactly 0."""
    jspec, tspec = _specs()
    q, k, v, g = _inputs(1, seed=3)
    scale = 1.0 / np.sqrt(HD)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, m, l = tfa._fused_fwd(tspec, tq, tk, tv, scale, 1)
    D = (tg * out).sum(-1)
    tm = tspec.flash_meta("cpu")
    args = (tm["block_cols"], tm["nblocks"], tm["mask_slot"],
            tm["is_partial"], tm["pmask"], tq, tk, tv, tg, m, l, D)
    kw = dict(heads=H, scale=scale, max_bpr=tm["max_bpr"])
    assert tm["max_bpr"] > tiles
    whole = tfs.flash_sparse_bwd_fused_plain(*args, **kw)
    split = tfs.flash_sparse_bwd_split_plain(*args, tiles=tiles, **kw)
    np.testing.assert_allclose(split[0].numpy(), whole[0].numpy(),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(split[1:], whole[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert np.all(split[0][:H, MASKED_ROW].numpy() == 0.0)
    jm = jfs.build_flash_bwd_meta(jspec.views)
    R, m_pad = B * H, tspec.m_pad
    stats = np.zeros((R, m_pad, 128), np.float32)
    stats[:, :, 0], stats[:, :, 1] = m.numpy(), l.numpy()
    dcoef = np.zeros((R, m_pad, 128), np.float32)
    dcoef[:, :S] = D.numpy()[:, :, None]
    j_dq, _, _ = jfs.flash_sparse_bwd_fused(
        *[jnp.asarray(jm[x]) for x in ("block_cols", "nblocks", "mask_slot",
                                       "is_partial", "pmask")],
        q * np.float32(scale), k, v, g, stats, dcoef, mb=jspec.mb,
        kb=jspec.kb, max_bpr=jm["max_bpr"], R=R, heads=H, bm=TILE, bk=TILE,
        group=1, interpret=True)
    np.testing.assert_allclose(split[0].numpy(), np.asarray(j_dq)[:, :S],
                               **TOL)


@pytest.mark.parametrize("nb,group,tiles", [(1, 1, 1), (7, 1, 2), (7, 2, 3),
                                             (32, 2, 16), (5, 4, 6),
                                             (3, 2, 100), (0, 2, 2)])
def test_column_walk_split_plan_covers_every_slot_once(nb, group, tiles):
    """B10c's split plan (``flash_dkv_chunks``): the chunks of one key
    block's walk (its group's query replicas one after another, nb slots
    each) hold every (replica, slot) exactly once, in walk order, at most
    ``tiles`` a chunk and no more chunks than the kernel launches."""
    chunks = tfs.flash_dkv_chunks(nb, group, tiles)
    walk = [(gi, u) for gi in range(group) for u in range(nb)]
    assert [x for c in chunks for x in c] == walk
    assert all(0 < len(c) <= tiles for c in chunks)
    assert len(chunks) == -(-group * nb // tiles)
    # the kernel sizes its grid from the longest walk: every walk fits
    longest = group * (nb + 1)
    assert len(chunks) <= -(-longest // tiles)


@pytest.mark.parametrize("group,tiles", [(1, 1), (1, 3), (2, 2), (2, 5)])
def test_split_column_walk_sums_to_the_unsplit_one(group, tiles):
    """The column walk's split plan through its plain twin: each chunk's
    partial dk / dv summed in chunk order equals the unsplit walk's to f32
    rounding and JAX's dk/dv kernel (interpret mode) at this file's
    tolerance; the key columns no query attends stay exactly 0."""
    jspec, tspec = _specs()
    q, k, v, g = _inputs(group, seed=4)
    scale = 1.0 / np.sqrt(HD)
    R = B * H
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, m, l = tfa._fused_fwd(tspec, tq, tk, tv, scale, group)
    D = (tg * out).sum(-1)
    bm = tspec.flash_bwd_meta("cpu")
    args = (bm["t_src_i"], bm["t_nblocks"], bm["t_mask_slot"],
            bm["t_is_partial"], bm["pmask"], tq, tk, tv, tg, m, l, D)
    kw = dict(heads=H, scale=scale, group=group, max_bpc=bm["max_bpc"])
    assert group * bm["max_bpc"] > tiles
    whole = tfs.flash_sparse_bwd_dkv_plain(*args, **kw)
    split = tfs.flash_sparse_bwd_dkv_split_plain(*args, tiles=tiles, **kw)
    for a, b in zip(split, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert np.all(a[H // group:, 20:36].numpy() == 0.0)
    m_pad = tspec.m_pad
    stats = np.zeros((R, m_pad, 128), np.float32)
    stats[:, :, 0], stats[:, :, 1] = m.numpy(), l.numpy()
    dcoef = np.zeros((R, m_pad, 128), np.float32)
    dcoef[:, :S] = D.numpy()[:, :, None]
    jm = jfs.build_flash_bwd_meta(jspec.views)
    j_dk, j_dv = jfs.flash_sparse_bwd_dkv(
        *[jnp.asarray(jm[x]) for x in ("t_src_i", "t_nblocks",
                                       "t_mask_slot", "t_is_partial",
                                       "pmask")],
        q * np.float32(scale), k, v, g, stats, dcoef, kb=jspec.kb,
        max_bpc=jm["max_bpc"], R=R, heads=H, bm=TILE, bk=TILE, group=group,
        interpret=True)
    for a, j in zip(split, (j_dk, j_dv)):
        j = np.asarray(j).reshape(R // group, group, -1, HD).sum(1)[:, :S]
        np.testing.assert_allclose(a.numpy(), j, **TOL)


def _jax_grads(jspec, q, k, v, g, group):
    out, vjp = jax.vjp(lambda a, b_, c: jfa.fused_sparse_attention(
        jspec, a, b_, c, group=group), q, k, v)
    return np.asarray(out), [np.asarray(x) for x in vjp(g)]


def _torch_grads(tspec, q, k, v, g, group):
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = stt.fused_sparse_attention(tspec, *ins, group=group)
    return out, torch.autograd.grad(out, ins, torch.from_numpy(g))


@pytest.mark.parametrize("route", ["fused", "two_kernel"], indirect=True)
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_gradients_match_jax(backend, group, route):
    jspec, tspec = _specs()
    q, k, v, g = _inputs(group)
    assert tfa._use_fused_bwd(tspec, tfa._hd_pad(HD)) == (route == "fused")
    st.set_backend(backend)
    try:
        ref_out, ref = _jax_grads(jspec, q, k, v, g, group)
    finally:
        st.set_backend("auto")
    out, got = _torch_grads(tspec, q, k, v, g, group)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, **TOL)
    for a, b_, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(a.numpy(), b_, **TOL, err_msg=f"d{name}")
    assert np.all(got[0][:H, MASKED_ROW].numpy() == 0.0)   # exactly 0


@pytest.mark.parametrize("group", [1, 2])
def test_backward_routes_agree(group):
    """The single-pass backward and the two-kernel backward (forced by the
    module constant) give the same gradients."""
    _, tspec = _specs()
    q, k, v, g = _inputs(group, seed=3)
    assert tfa._use_fused_bwd(tspec, tfa._hd_pad(HD))
    _, fused = _torch_grads(tspec, q, k, v, g, group)
    old = tfa._FUSED_BWD_ACC_BYTES
    tfa._FUSED_BWD_ACC_BYTES = 0
    try:
        _, two = _torch_grads(tspec, q, k, v, g, group)
    finally:
        tfa._FUSED_BWD_ACC_BYTES = old
    for a, b_ in zip(fused, two):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-5)


def test_gradcheck_float64():
    """float64 ``gradcheck`` of the autograd Function through the plain
    backward (both routes), with GQA."""
    s, hd = 20, 4
    masks = np.stack([np.tril(np.ones((s, s)))] * 2)
    masks[0, 5] = 0.0
    _, tspec = _specs(masks, heads=2)
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(4, s, hd)).requires_grad_()
    k, v = (torch.from_numpy(rng.randn(2, s, hd)).requires_grad_()
            for _ in range(2))

    def fn(a, b_, c):
        return stt.fused_sparse_attention(tspec, a, b_, c, group=2)

    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-6)
    old = tfa._FUSED_BWD_ACC_BYTES
    tfa._FUSED_BWD_ACC_BYTES = 0
    try:
        assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-6)
    finally:
        tfa._FUSED_BWD_ACC_BYTES = old


def test_warm_flash_meta_builds_the_route_tables():
    _, tspec = _specs()
    tfa.warm_flash_meta(tspec, "cpu", backward=True, hd=HD)
    assert set(k for k, _ in tspec._meta_dev) == {"fwd"}   # fused route
    old = tfa._FUSED_BWD_ACC_BYTES
    tfa._FUSED_BWD_ACC_BYTES = 0
    try:
        tfa.warm_flash_meta(tspec, "cpu", backward=False, hd=HD)
        assert set(k for k, _ in tspec._meta_dev) == {"fwd"}
        tfa.warm_flash_meta(tspec, "cpu", backward=True, hd=HD)
        assert set(k for k, _ in tspec._meta_dev) == {"fwd", "bwd"}
    finally:
        tfa._FUSED_BWD_ACC_BYTES = old
