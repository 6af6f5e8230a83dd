"""Sparse-flash attention forward of the PyTorch port (plain version on the
CPU) against the JAX package's ``fused_sparse_attention``: its unfused
oracle under ``set_backend("xla")`` and its Pallas kernel in interpret mode
under ``set_backend("pallas")``, at the same tiles. Tolerance atol = 1e-4.
"""

import numpy as np
import pytest
import torch

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu import many_mask as jmm
from sputnik_tpu.ops import batched_panel as jbp
from sputnik_tpu.ops import fused_attention as jfa
from sputnik_tpu_torch.ops import fused_attention as tfa
from sputnik_tpu_torch.ops.batched_panel import BatchedPanelSpec

B, H, S, HD, TILE = 2, 4, 64, 32, 16


@pytest.fixture(params=["xla", "pallas"])
def backend(request):
    st.set_backend(request.param)
    try:
        yield request.param
    finally:
        st.set_backend("auto")


def _masks():
    rng = np.random.RandomState(0)
    masks = np.stack([np.tril(np.ones((S, S), np.float32)),
                      (rng.rand(S, S) < 0.35).astype(np.float32)])
    masks[0, 9, :] = 0.0            # fully-masked row
    return masks


def _specs(masks, heads=H, tile=TILE):
    jspec = jbp.BatchedPanelSpec.from_many_mask(
        jmm.ManyMaskTopology.from_dense_masks(masks), heads=heads, bm=tile,
        bk=tile)
    tspec = BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=heads, bm=tile,
        bk=tile)
    return jspec, tspec


def _qkv(r_q, r_kv, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(r_q, S, HD).astype(np.float32),
            rng.randn(r_kv, S, HD).astype(np.float32),
            rng.randn(r_kv, S, HD).astype(np.float32))


@pytest.mark.parametrize("group", [1, 2])
def test_forward_matches_jax(backend, group):
    jspec, tspec = _specs(_masks())
    q, k, v = _qkv(B * H, B * H // group)
    ref = np.asarray(jfa.fused_sparse_attention(jspec, q, k, v, group=group))
    got = stt.fused_sparse_attention(tspec, *map(torch.from_numpy, (q, k, v)),
                                     group=group)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    assert torch.isfinite(got).all()
    # replicas of batch element 0 have the fully-masked row 9: exactly 0
    assert np.all(got[:H, 9].numpy() == 0.0)


def test_row_stats_match_pallas_packed_stats():
    """m / l equal lanes 0 / 1 of the Pallas kernel's packed stats."""
    jspec, tspec = _specs(_masks())
    q, k, v = _qkv(B * H, B * H)
    scale = 1.0 / np.sqrt(HD)
    st.set_backend("pallas")
    try:
        ref_out, stats = jfa._fused_fwd_impl(jspec, q, k, v, scale, 1,
                                             want_stats=True)
    finally:
        st.set_backend("auto")
    stats = np.asarray(stats)
    out, m, l = tfa._fused_fwd(tspec, *map(torch.from_numpy, (q, k, v)),
                               scale, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-4)
    assert m.shape == l.shape == (B * H, tspec.m_pad)
    np.testing.assert_allclose(m.numpy(), stats[:, :, 0], atol=1e-4)
    np.testing.assert_allclose(l.numpy(), stats[:, :, 1], atol=1e-4)
    # the fully-masked row keeps the finite sentinel and a zero denominator
    assert np.all(m[:H, 9].numpy() == np.float32(-1e30))
    assert np.all(l[:H, 9].numpy() == 0.0)


@pytest.mark.parametrize("tile", [16, 64])
def test_tiles_do_not_change_the_result(tile):
    """The kernel's 64 x 64 tiling and a small tiling agree (non-multiple
    sequence length included)."""
    s = 40
    masks = np.stack([np.tril(np.ones((s, s), np.float32))] * B)
    masks[1, 3] = 0.0
    tspec = BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=H, bm=tile,
        bk=tile)
    ref_spec = BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=H, bm=8, bk=8)
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(B * H, s, HD).astype(np.float32))
               for _ in range(3))
    got = stt.fused_sparse_attention(tspec, q, k, v)
    ref = stt.fused_sparse_attention(ref_spec, q, k, v)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


def test_argument_checks():
    _, tspec = _specs(_masks())
    q, k, v = map(torch.from_numpy, _qkv(B * H, B * H))
    with pytest.raises(ValueError):
        stt.fused_sparse_attention(tspec, q[:1], k, v)
    with pytest.raises(ValueError):
        stt.fused_sparse_attention(tspec, q[:, :8], k, v)
    with pytest.raises(ValueError):
        stt.fused_sparse_attention(tspec, q, k, v, group=3)
    with pytest.raises(ValueError):
        stt.fused_sparse_attention(tspec, q, k[:2], v[:2], group=2)


def test_flash_meta_cached_per_device():
    _, tspec = _specs(_masks())
    a = tspec.flash_meta("cpu")
    assert tspec.flash_meta(torch.device("cpu")) is a
    assert a["block_cols"].dtype == torch.int32
    assert a["pmask"].dtype == torch.float32


def test_plain_path_is_differentiable_on_cpu():
    """Gradients flow on the CPU, through the autograd Function's plain
    backward (``tests/test_torch_flash_backward.py`` holds them against
    JAX)."""
    _, tspec = _specs(_masks())
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(B * H, B * H))
    out = stt.fused_sparse_attention(tspec, q, k, v)
    out.square().sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    assert q.grad.abs().sum() > 0
