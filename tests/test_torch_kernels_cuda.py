"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``requires_cuda``) and skips
without one. This file imports no JAX, so it also runs where JAX is not
installed; there run it without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerance: max |kernel - plain| <= 1e-4 * max(1, max |plain|) (f32 sums
taken in another order). TF32 is switched off for the plain versions.
"""

import numpy as np
import pytest
import torch

import sputnik_tpu_torch as stt
from sputnik_tpu_torch.ops.kernels.bsr_sddmm import (bsr_sddmm_panel,
                                                      bsr_sddmm_panel_plain)
from sputnik_tpu_torch.ops.kernels.bsr_spmm import (bsr_spmm_panel,
                                                     bsr_spmm_panel_plain)
from sputnik_tpu_torch.ops.kernels.flash_sparse import (
    flash_sparse_attention_fwd, flash_sparse_attention_fwd_plain)
from sputnik_tpu_torch.patterns import driver_masks

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref):
    err = (got - ref).abs().max().item() if ref.numel() else 0.0
    bound = 1e-4 * max(1.0, ref.abs().max().item() if ref.numel() else 0.0)
    assert err <= bound, (err, bound)


def _meta(spec, dev):
    return {k: v.to(dev) for k, v in spec.meta("cpu").items()}


@pytest.mark.parametrize("tiles", [(64, 64), (32, 96), (128, 48)])
@pytest.mark.parametrize("epilogue", ["none", "bias", "bias_relu"])
def test_spmm_kernel_matches_plain(dev, tiles, epilogue):
    rng = np.random.RandomState(0)
    m, n, q, R = 200, 150, 130, 3
    mask = rng.rand(m, n) < 0.1
    mask[17] = False
    topo = stt.SparseTopology.from_dense_mask(mask)
    spec = stt.PanelSpec(topo, *tiles)
    w = (mask * rng.randn(m, n)).astype(np.float32)
    vals = stt.SparseMatrix(w).values
    panel = torch.from_numpy(np.stack([
        stt.ops.panel_api.values_to_panel_np(topo, vals * (r + 1), *tiles)
        for r in range(R)])).to(dev)
    dense = torch.from_numpy(rng.randn(R, n, q).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.randn(m).astype(np.float32)).to(dev)
    meta = _meta(spec, dev)
    before = bsr_spmm_panel.launches
    got = bsr_spmm_panel(meta["block_cols"], meta["nblocks"], panel, dense,
                         bias, rows=m, epilogue=epilogue)
    torch.cuda.synchronize()
    assert bsr_spmm_panel.launches == before + 1
    ref = bsr_spmm_panel_plain(meta["block_cols"], meta["nblocks"], panel,
                               dense, bias, rows=m, epilogue=epilogue)
    _close(got, ref)


@pytest.mark.parametrize("tiles", [(64, 64), (32, 96)])
@pytest.mark.parametrize("d", [20, 64, 100])
def test_sddmm_kernel_matches_plain_with_exact_zeros(dev, tiles, d):
    rng = np.random.RandomState(1)
    m, n, R = 150, 170, 2
    mask = rng.rand(m, n) < 0.05
    topo = stt.SparseTopology.from_dense_mask(mask)
    spec = stt.PanelSpec(topo, *tiles)
    meta = _meta(spec, dev)
    lhs = torch.from_numpy(rng.randn(R, m, d).astype(np.float32)).to(dev)
    rhs = torch.from_numpy(rng.randn(R, n, d).astype(np.float32)).to(dev)
    got = bsr_sddmm_panel(meta["block_cols"], meta["nblocks"], lhs, rhs,
                          meta["mask"])
    torch.cuda.synchronize()
    ref = bsr_sddmm_panel_plain(meta["block_cols"], meta["nblocks"], lhs,
                                rhs, meta["mask"])
    _close(got, ref)
    keep = torch.from_numpy(spec.view.mask).to(dev)
    assert torch.all(got[:, ~keep] == 0)   # padded + masked: exact zeros


@pytest.mark.parametrize("hd", [32, 64, 100, 128])
@pytest.mark.parametrize("group", [1, 2])
def test_flash_kernel_matches_plain(dev, hd, group):
    b, heads, s = 2, 4, 200
    masks = driver_masks(b, s)
    masks[1] *= (np.random.RandomState(2).rand(s, s) < 0.5)
    spec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=heads)
    meta = spec.flash_meta(dev)
    rng = np.random.RandomState(3)
    R = b * heads
    q = torch.from_numpy(rng.randn(R, s, hd).astype(np.float32)).to(dev)
    k, v = (torch.from_numpy(rng.randn(R // group, s, hd).astype(np.float32)
                             ).to(dev) for _ in range(2))
    args = (meta["block_cols"], meta["nblocks"], meta["mask_slot"],
            meta["is_partial"], meta["pmask"], q, k, v)
    kw = dict(heads=heads, max_bpr=meta["max_bpr"], scale=hd ** -0.5,
              group=group)
    out, m, l = flash_sparse_attention_fwd(*args, **kw)
    torch.cuda.synchronize()
    ref, m_ref, l_ref = flash_sparse_attention_fwd_plain(*args, **kw)
    _close(out, ref)
    _close(l, l_ref)
    live = l_ref > 0
    _close(m[live], m_ref[live])
    assert torch.all(out[:, s // 2] == 0)      # fully-masked row: exact 0
    assert torch.all(m[:, s // 2] == -1e30) and torch.all(l[:, s // 2] == 0)


@pytest.mark.parametrize("seed", range(8))
def test_kernels_match_plain_on_random_shapes(dev, seed):
    """Seeded sweep over ragged shapes, tiles and densities (empty rows,
    tiny dims, non-multiple sizes) for all three kernels."""
    rng = np.random.RandomState(100 + seed)
    m, n = rng.randint(1, 300, size=2)
    bm, bk = rng.choice([16, 32, 48, 64, 96, 128], size=2)
    mask = rng.rand(m, n) < rng.choice([0.01, 0.1, 0.5])
    topo = stt.SparseTopology.from_dense_mask(mask)
    spec = stt.PanelSpec(topo, int(bm), int(bk))
    meta = _meta(spec, dev)
    R, q, d = rng.randint(1, 4), rng.randint(1, 200), rng.randint(1, 130)
    panel = torch.from_numpy(rng.randn(R, *spec.view.values_shape).astype(
        np.float32)).to(dev) * meta["mask"]
    dense = torch.from_numpy(rng.randn(R, n, q).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.randn(m).astype(np.float32)).to(dev)
    args = (meta["block_cols"], meta["nblocks"], panel, dense, bias)
    _close(bsr_spmm_panel(*args, rows=m, epilogue="bias_relu"),
           bsr_spmm_panel_plain(*args, rows=m, epilogue="bias_relu"))
    lhs = torch.from_numpy(rng.randn(R, m, d).astype(np.float32)).to(dev)
    rhs = torch.from_numpy(rng.randn(R, n, d).astype(np.float32)).to(dev)
    sargs = (meta["block_cols"], meta["nblocks"], lhs, rhs, meta["mask"])
    _close(bsr_sddmm_panel(*sargs), bsr_sddmm_panel_plain(*sargs))

    b, heads, s = rng.randint(1, 4), int(rng.choice([1, 2, 4])), int(m)
    hd, group = rng.randint(1, 129), int(rng.choice([1, heads]))
    masks = (rng.rand(b, s, s) < rng.choice([0.05, 0.3, 1.0])).astype(
        np.float32)
    fspec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=heads)
    fm = fspec.flash_meta(dev)
    R = b * heads
    q_, k_, v_ = (torch.from_numpy(rng.randn(r, s, hd).astype(np.float32)
                                   ).to(dev)
                  for r in (R, R // group, R // group))
    fargs = (fm["block_cols"], fm["nblocks"], fm["mask_slot"],
             fm["is_partial"], fm["pmask"], q_, k_, v_)
    kw = dict(heads=heads, max_bpr=fm["max_bpr"], scale=0.3, group=group)
    out, _, l = flash_sparse_attention_fwd(*fargs, **kw)
    ref, _, l_ref = flash_sparse_attention_fwd_plain(*fargs, **kw)
    _close(out, ref)
    _close(l, l_ref)


def test_kernels_refuse_grad_mode(dev):
    topo = stt.SparseTopology.from_dense_mask(np.ones((64, 64)))
    lin = stt.SparseLinear(topo).to(dev)
    x = torch.randn(4, 64, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lin(x)
    with torch.no_grad():
        assert lin(x).shape == (4, 64)


def test_wrappers_check_operands(dev):
    topo = stt.SparseTopology.from_dense_mask(np.ones((64, 64)))
    spec = stt.PanelSpec(topo)
    meta = _meta(spec, dev)
    panel = torch.zeros((1,) + spec.view.values_shape, device=dev)
    dense = torch.zeros(1, 64, 8, device=dev)
    with pytest.raises(TypeError):
        bsr_spmm_panel(meta["block_cols"].long(), meta["nblocks"], panel,
                       dense, rows=64)
    with pytest.raises(ValueError):
        bsr_spmm_panel(meta["block_cols"], meta["nblocks"], panel,
                       dense.transpose(1, 2).contiguous().transpose(1, 2),
                       rows=64)
