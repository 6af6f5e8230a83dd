"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``requires_cuda``) and skips
without one. This file imports no JAX, so it also runs where JAX is not
installed; there run it without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerance: max |kernel - plain| <= 1e-4 * max(1, max |plain|) (f32 sums
taken in another order). TF32 is switched off for the plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sputnik_tpu_torch as stt
from sputnik_tpu_torch.ops import kernels
from sputnik_tpu_torch.ops.kernels import batched_panel as kbp
from sputnik_tpu_torch.ops.kernels import bsr_spmm_int8 as kbi8
from sputnik_tpu_torch.ops.kernels import flash_sparse_int8 as kfi8
from sputnik_tpu_torch.ops.kernels.bsr_sddmm import (bsr_sddmm_panel,
                                                      bsr_sddmm_panel_plain)
from sputnik_tpu_torch.ops.kernels import flash_sparse as fs
from sputnik_tpu_torch.ops.kernels.bsr_spmm import (bsr_spmm_panel,
                                                     bsr_spmm_panel_plain)
from sputnik_tpu_torch.ops.kernels.bsr_spmm_t import (bsr_spmm_t_panel,
                                                       bsr_spmm_t_panel_plain)
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
@pytest.mark.parametrize("d", [7, 20, 64, 100, 640])
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


def _flash_masks(shape):
    """(masks, heads): the driver's masks (row s // 2 fully masked) with a
    random second mask, or one causal mask at s = 2048 (the longest walk:
    32 slots)."""
    if shape == "causal2048":
        masks = np.tril(np.ones((1, 2048, 2048), np.float32))
        masks[0, 1000] = 0.0                   # a fully-masked row
        return masks, 2
    masks = driver_masks(2, 200)
    masks[1] *= (np.random.RandomState(2).rand(200, 200) < 0.5)
    return masks, 4


def _split_walk(monkeypatch, split):
    """Force the forward kernel's split plan: every walk cut into chunks of
    ``MIN_SPLIT_TILES`` slots, or none cut."""
    monkeypatch.setattr(fs, "SPLIT_CTAS", 10 ** 9 if split else 0)


@pytest.mark.parametrize("split", [False, True], ids=["walk", "split"])
@pytest.mark.parametrize("shape", ["driver", "causal2048"])
@pytest.mark.parametrize("hd", [16, 32, 64, 100, 128])
@pytest.mark.parametrize("group", [1, 2])
def test_flash_kernel_matches_plain(dev, hd, group, shape, split,
                                    monkeypatch):
    """B9 (split TF32 on the tensor cores) against its plain version at the
    zero-padded head dims (16, 100) and both widths of its body (64, 128),
    GQA, the longest causal walk, walked whole or split and merged: the
    same bits twice, m bit-equal between the two plans, a fully-masked row
    exactly 0."""
    masks, heads = _flash_masks(shape)
    b, s = masks.shape[:2]
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
    _split_walk(monkeypatch, split)
    assert (fs.flash_split_tiles(R * spec.mb, meta["max_bpr"])
            < meta["max_bpr"]) == split
    out, m, l = flash_sparse_attention_fwd(*args, **kw)
    again = flash_sparse_attention_fwd(*args, **kw)
    torch.cuda.synchronize()
    for a, b_ in zip((out, m, l), again):
        assert torch.equal(a.view(torch.int32), b_.view(torch.int32))
    ref, m_ref, l_ref = flash_sparse_attention_fwd_plain(*args, **kw)
    _close(out, ref)
    _close(l, l_ref)
    live = l_ref > 0
    _close(m[live], m_ref[live])
    _split_walk(monkeypatch, not split)
    _, m_other, _ = flash_sparse_attention_fwd(*args, **kw)
    assert torch.equal(m, m_other)
    dead = 1000 if shape == "causal2048" else s // 2
    assert torch.all(out[:, dead] == 0)        # fully-masked row: exact 0
    assert torch.all(m[:, dead] == -1e30) and torch.all(l[:, dead] == 0)


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
    """A raw kernel launch records no gradient, so in grad mode the wrapper
    refuses it and names the autograd op; the modules train through those
    ops, whose backward launches the backward kernels."""
    topo = stt.SparseTopology.from_dense_mask(np.ones((64, 64)))
    lin = stt.SparseLinear(topo).to(dev)
    x = torch.randn(4, 64, device=dev, requires_grad=True)
    meta = lin.spec.meta(dev)
    with pytest.raises(RuntimeError, match="panel_api.spmm"):
        bsr_spmm_panel(meta["block_cols"], meta["nblocks"], lin.values[None],
                       x.T.contiguous()[None], rows=64)
    before = bsr_spmm_t_panel.launches
    y = lin(x)
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert bsr_spmm_t_panel.launches == before + 1
    assert x.grad is not None and lin.values.grad is not None
    w = torch.from_numpy(lin.unpack_dense(lin.values)).to(dev)
    ref_x = torch.autograd.grad((x @ w.T + lin.bias).square().sum(), x)[0]
    _close(x.grad, ref_x)


def _bwd_problem(dev, b, heads, s, hd, group, seed):
    rng = np.random.RandomState(seed)
    masks = driver_masks(b, s)                   # row s // 2 fully masked
    if b > 1:
        masks[1] *= rng.rand(s, s) < 0.5
        masks[1][:, s // 3: s // 3 + 70] = 0.0   # keys no query attends
    spec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=heads)
    R = b * heads
    q, g = (torch.from_numpy(rng.randn(R, s, hd).astype(np.float32)).to(dev)
            for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(R // group, s, hd).astype(np.float32)
                             ).to(dev) for _ in range(2))
    fm = spec.flash_meta(dev)
    kw = dict(heads=heads, scale=hd ** -0.5, group=group)
    out, m, l = flash_sparse_attention_fwd_plain(
        fm["block_cols"], fm["nblocks"], fm["mask_slot"], fm["is_partial"],
        fm["pmask"], q, k, v, max_bpr=fm["max_bpr"], **kw)
    D = (g * out).sum(-1)
    return spec, (q, k, v, g, m, l, D), kw


@pytest.mark.parametrize("split", [False, True], ids=["walk", "split"])
@pytest.mark.parametrize("hd", [32, 64, 100, 128])
@pytest.mark.parametrize("group", [1, 2])
def test_flash_backward_kernels_match_plain(dev, hd, group, split,
                                            monkeypatch):
    """B10a / B10b / B10c against their plain versions: s = 200 (not a
    multiple of 64), a fully-masked row (dq exactly 0) and key columns no
    query attends (dk = dv = 0); the row walk whole and split into chunks
    (merged in chunk order), its dq the same bits twice."""
    _split_walk(monkeypatch, split)
    b, heads, s = 2, 4, 200
    spec, ops, kw = _bwd_problem(dev, b, heads, s, hd, group, seed=hd + group)
    fm, bm = spec.flash_meta(dev), spec.flash_bwd_meta(dev)
    rargs = (fm["block_cols"], fm["nblocks"], fm["mask_slot"],
             fm["is_partial"], fm["pmask"], *ops)
    targs = (bm["t_src_i"], bm["t_nblocks"], bm["t_mask_slot"],
             bm["t_is_partial"], bm["pmask"], *ops)
    ref = fs.flash_sparse_bwd_fused_plain(*rargs, max_bpr=fm["max_bpr"], **kw)
    got = fs.flash_sparse_bwd_fused(*rargs, max_bpr=fm["max_bpr"], **kw)
    dq = fs.flash_sparse_bwd_dq(*rargs, max_bpr=fm["max_bpr"], **kw)
    dk, dv = fs.flash_sparse_bwd_dkv(*targs, max_bpc=bm["max_bpc"], **kw)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        _close(a, r)
    _close(dq, ref[0])
    _close(dk, ref[1])
    _close(dv, ref[2])
    for x in (got[0], dq):
        assert torch.all(x[:heads, s // 2] == 0)  # fully-masked row
    dead = slice(s // 3 + 6, s // 3 + 64)         # no query of mask 1 reads
    rk = heads // group                           # first KV replica of b=1
    assert torch.all(dk[rk:, dead] == 0) and torch.all(dv[rk:, dead] == 0)
    # dq takes no float atomics: the same bits twice
    assert torch.equal(
        dq, fs.flash_sparse_bwd_dq(*rargs, max_bpr=fm["max_bpr"], **kw))
    assert torch.equal(got[0], fs.flash_sparse_bwd_fused(
        *rargs, max_bpr=fm["max_bpr"], **kw)[0])


@pytest.mark.parametrize("split", [False, True], ids=["walk", "split"])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_backward_row_walk_emptied_and_deep(dev, hd, split,
                                                  monkeypatch):
    """The tensor-core row walk (B10a, B10b) at s = 1000 causal (walks of up
    to 16 slots, partial diagonal tiles) with row block 3 emptied (no tile:
    its dq exactly 0) and a ragged last block, whole and split, against
    the plain version and against float64."""
    _split_walk(monkeypatch, split)
    s, heads = 1000, 2
    masks = np.tril(np.ones((1, s, s), np.float32))
    masks[0, 192:256] = 0.0
    spec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=heads)
    rng = np.random.RandomState(hd)
    q, k, v, g = (torch.from_numpy(rng.randn(heads, s, hd).astype(
        np.float32)).to(dev) for _ in range(4))
    fm = spec.flash_meta(dev)
    kw = dict(heads=heads, scale=hd ** -0.5, max_bpr=fm["max_bpr"])
    meta = (fm["block_cols"], fm["nblocks"], fm["mask_slot"],
            fm["is_partial"], fm["pmask"])
    out, m, l = flash_sparse_attention_fwd(*meta, q, k, v, **kw)
    D = (g * out).sum(-1)
    ops = (q, k, v, g, m, l, D)
    got = fs.flash_sparse_bwd_fused(*meta, *ops, **kw)
    dq = fs.flash_sparse_bwd_dq(*meta, *ops, **kw)
    torch.cuda.synchronize()
    ref = fs.flash_sparse_bwd_fused_plain(*meta, *ops, **kw)
    ref64 = fs.flash_sparse_bwd_fused_plain(
        *meta, *(x.double() for x in ops), **kw)
    for a, r, r64 in zip(got, ref, ref64):
        _close(a, r)
        _close(a, r64.float())
    _close(dq, ref[0])
    assert torch.all(got[0][:, 192:256] == 0) and torch.all(
        dq[:, 192:256] == 0)


def test_flash_kernels_refuse_head_dims_above_128(dev):
    """The flash family's card limit (B9-B11b, B18a-c): hd <= 128; the CPU
    plain path runs any hd."""
    masks = driver_masks(1, 128)
    spec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=1)
    fm, bm = spec.flash_meta(dev), spec.flash_bwd_meta(dev)
    meta = (fm["block_cols"], fm["nblocks"], fm["mask_slot"],
            fm["is_partial"], fm["pmask"])
    tmeta = (bm["t_src_i"], bm["t_nblocks"], bm["t_mask_slot"],
             bm["t_is_partial"], bm["pmask"])
    x = torch.zeros(1, 128, 192, device=dev)
    st = torch.zeros(1, 128, device=dev)
    ops = (x, x, x, x, st, st, st)
    kw = dict(heads=1, scale=1.0)
    calls = [
        lambda: flash_sparse_attention_fwd(*meta, x, x, x,
                                           max_bpr=fm["max_bpr"], **kw),
        lambda: fs.flash_sparse_bwd_fused(*meta, *ops,
                                          max_bpr=fm["max_bpr"], **kw),
        lambda: fs.flash_sparse_bwd_dq(*meta, *ops, max_bpr=fm["max_bpr"],
                                       **kw),
        lambda: fs.flash_sparse_bwd_dkv(*tmeta, *ops,
                                        max_bpc=bm["max_bpc"], **kw),
        lambda: kfi8.flash_sparse_attention_fwd_int8(
            *meta, x, x, x, max_bpr=fm["max_bpr"], **kw),
        lambda: kfi8.flash_sparse_bwd_dq_int8(*meta, *ops,
                                              max_bpr=fm["max_bpr"], **kw),
        lambda: kfi8.flash_sparse_bwd_dkv_int8(*tmeta, *ops,
                                               max_bpc=bm["max_bpc"], **kw),
        lambda: fs.flash_sparse_ring_band_fwd(
            *(t[0] for t in meta), x, x, x, x.clone(), st.clone(),
            st.clone(), max_bpr=fm["max_bpr"]),
        lambda: fs.flash_sparse_ring_band_bwd(
            *(t[0] for t in meta), x, x, x, x, st, st, st, x.clone(),
            x.clone(), x.clone(), max_bpr=fm["max_bpr"]),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="head dim 192 > 128"):
            call()


@pytest.mark.parametrize("tiles", [(64, 64), (32, 96), (128, 48)])
def test_spmm_t_kernel_matches_plain_and_dense(dev, tiles):
    """B3 against its plain version and a dense ``A^T @ G``, with an empty
    block column (written as exact zeros) and ragged edges."""
    rng = np.random.RandomState(5)
    m, n, q, R = 200, 150, 130, 3
    mask = rng.rand(m, n) < 0.1
    mask[:, : tiles[1] + 5] = False
    topo = stt.SparseTopology.from_dense_mask(mask)
    spec = stt.PanelSpec(topo, *tiles)
    meta = _meta(spec, dev)
    w = (mask * rng.randn(m, n)).astype(np.float32)
    vals = stt.SparseMatrix(w).values
    panel = torch.from_numpy(np.stack([
        stt.ops.panel_api.values_to_panel_np(topo, vals * (r + 1), *tiles)
        for r in range(R)])).to(dev)
    g = torch.from_numpy(rng.randn(R, m, q).astype(np.float32)).to(dev)
    args = (meta["t_src_i"], meta["t_src_s"], meta["t_nblocks"], panel, g)
    got = bsr_spmm_t_panel(*args, rows=n)
    torch.cuda.synchronize()
    _close(got, bsr_spmm_t_panel_plain(*args, rows=n))
    a = torch.from_numpy(w).to(dev)
    _close(got, torch.stack([(r + 1) * a.T @ g[r] for r in range(R)]))
    assert torch.all(got[:, : tiles[1]] == 0)


@pytest.mark.parametrize("seed", range(6))
def test_backward_kernels_match_plain_on_random_shapes(dev, seed):
    """Seeded sweep over ragged shapes, tiles, densities, hd and GQA groups
    for B3 and B10a/b/c."""
    rng = np.random.RandomState(200 + seed)
    m, n = rng.randint(1, 300, size=2)
    bm, bk = rng.choice([16, 32, 48, 64, 96, 128], size=2)
    mask = rng.rand(m, n) < rng.choice([0.01, 0.1, 0.5])
    spec = stt.PanelSpec(stt.SparseTopology.from_dense_mask(mask), int(bm),
                         int(bk))
    meta = _meta(spec, dev)
    R, q = rng.randint(1, 4), rng.randint(1, 200)
    panel = torch.from_numpy(rng.randn(R, *spec.view.values_shape).astype(
        np.float32)).to(dev) * meta["mask"]
    g = torch.from_numpy(rng.randn(R, m, q).astype(np.float32)).to(dev)
    args = (meta["t_src_i"], meta["t_src_s"], meta["t_nblocks"], panel, g)
    _close(bsr_spmm_t_panel(*args, rows=n),
           bsr_spmm_t_panel_plain(*args, rows=n))

    b, heads = rng.randint(1, 4), int(rng.choice([1, 2, 4]))
    s, hd = int(rng.randint(2, 300)), int(rng.choice([32, 64, 100, 128]))
    group = int(rng.choice([1, heads]))
    spec, ops, kw = _bwd_problem(dev, b, heads, s, hd, group, seed)
    fm, bmeta = spec.flash_meta(dev), spec.flash_bwd_meta(dev)
    rargs = (fm["block_cols"], fm["nblocks"], fm["mask_slot"],
             fm["is_partial"], fm["pmask"], *ops)
    ref = fs.flash_sparse_bwd_fused_plain(*rargs, max_bpr=fm["max_bpr"], **kw)
    for a, r in zip(fs.flash_sparse_bwd_fused(
            *rargs, max_bpr=fm["max_bpr"], **kw), ref):
        _close(a, r)
    _close(fs.flash_sparse_bwd_dq(*rargs, max_bpr=fm["max_bpr"], **kw),
           ref[0])
    dk, dv = fs.flash_sparse_bwd_dkv(
        bmeta["t_src_i"], bmeta["t_nblocks"], bmeta["t_mask_slot"],
        bmeta["t_is_partial"], bmeta["pmask"], *ops,
        max_bpc=bmeta["max_bpc"], **kw)
    _close(dk, ref[1])
    _close(dv, ref[2])


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


_CACHE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "int8": torch.int8}


def _decode_problem(dev, dtype, hd, bk, qlen, group, seed):
    """Caches written by ``prefill_kv`` (the int8 ones quantised), one
    replica near capacity, one empty, one a few keys into its second
    block; sinks + window tables from ``decode_block_table``, expanded to
    query replicas."""
    from sputnik_tpu_torch.ops import decode as D

    rng = np.random.RandomState(seed)
    R_kv, nb = 3, 2 if bk >= 512 else 4
    s_max = nb * bk
    lens = np.array([s_max - 1, 0, bk + 3], np.int32)
    ks, vs = (torch.from_numpy(rng.randn(R_kv, s_max, hd).astype(
        np.float32)).to(dev) for _ in range(2))
    cache = D.prefill_kv(
        D.init_kv_cache(R_kv, s_max, hd, _CACHE_DTYPES[dtype], device=dev),
        ks, vs, torch.from_numpy(lens).to(dev))
    tbl, valid = D.decode_block_table(cache.kv_len, s_max=s_max, bk=bk,
                                      window_blocks=2, sink_blocks=1)
    tbl = tbl.repeat_interleave(group, 0).contiguous()
    valid = valid.repeat_interleave(group, 0).contiguous()
    q = torch.from_numpy(rng.randn(R_kv * group, qlen, hd).astype(
        np.float32)).to(dev)
    return cache, tbl, valid, q


@pytest.mark.parametrize("bk", [8, 32, 200, 1024])
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("dtype", sorted(_CACHE_DTYPES))
def test_decode_attention_kernel_matches_plain(dev, dtype, hd, bk):
    """B19 against its plain version over qlen 1 / 4 / 8 and GQA group
    1 / 2 / 4; the empty replica's rows are exactly 0. bk = 200: key
    chunks that do not divide the block; a replica a few keys into its
    second block leaves the rest of its chunks empty. The same bits twice
    (the split's merge takes no atomics)."""
    from sputnik_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_kernel, decode_attention_plain)

    for qlen in (1, 4, 8):
        for group in (1, 2, 4):
            cache, tbl, valid, q = _decode_problem(
                dev, dtype, hd, bk, qlen, group, seed=hd + bk + qlen + group)
            args = (tbl, valid, cache.kv_len, q, cache.k, cache.v,
                    cache.k_scale, cache.v_scale)
            kw = dict(bk=bk, qlen=qlen, group=group, scale=hd ** -0.5)
            before = decode_attention_kernel.launches
            got = decode_attention_kernel(*args, **kw)
            torch.cuda.synchronize()
            assert decode_attention_kernel.launches == before + 1
            _close(got, decode_attention_plain(*args, **kw))
            assert torch.all(got[group:2 * group] == 0)
            assert torch.equal(got, decode_attention_kernel(*args, **kw))


@pytest.mark.parametrize("bk", [32, 1024])
@pytest.mark.parametrize("hd", [192, 200, 256])
@pytest.mark.parametrize("dtype", sorted(_CACHE_DTYPES))
def test_decode_kernels_at_wide_head_dims(dev, dtype, hd, bk):
    """B19 and B20a at head dims above 128 (two 128-wide groups a lane;
    hd 200 ragged in the second) against their plain versions over qlen
    1 / 4 / 8 and GQA group 1 / 2 / 4, the paged kernel on the same blocks
    as pages, the empty replica exactly 0, the same bits twice. f32 / bf16
    caches at 1e-4 * max(1, max|plain|). int8 caches: the card's expf and
    torch's exp differ in the last place now and then, which moves a
    p * v_scale code across a rounding tie, and one code step moves an
    output by max(p * vs) * |v| / (127 * l) (~1e-4 at bk = 1024); so every
    output within 1e-3 * max(1, max|plain|) and at most 0.1% of them
    beyond 1e-4 of it."""
    from sputnik_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_kernel, decode_attention_plain)
    from sputnik_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel, paged_attention_plain)

    def close(got, ref):
        if dtype != "int8":
            _close(got, ref)
            return
        lim = max(1.0, ref.abs().max().item())
        err = (got - ref).abs()
        print(f"int8 wide-head decode hd={hd} bk={bk}: max err "
              f"{err.max().item() / lim:.3e} x max(1, max|plain|), "
              f"{int((err > 1e-4 * lim).sum())} of {err.numel()} beyond "
              f"1e-4 of it")
        assert err.max().item() <= 1e-3 * lim, (err.max().item(), lim)
        assert (err > 1e-4 * lim).float().mean().item() <= 1e-3

    for qlen in (1, 4, 8):
        for group in (1, 2, 4):
            cache, tbl, valid, q = _decode_problem(
                dev, dtype, hd, bk, qlen, group, seed=hd + bk + qlen + group)
            args = (tbl, valid, cache.kv_len, q, cache.k, cache.v,
                    cache.k_scale, cache.v_scale)
            kw = dict(qlen=qlen, group=group, scale=hd ** -0.5)
            got = decode_attention_kernel(*args, bk=bk, **kw)
            torch.cuda.synchronize()
            close(got, decode_attention_plain(*args, bk=bk, **kw))
            assert torch.all(got[group:2 * group] == 0)
            assert torch.equal(got, decode_attention_kernel(*args, bk=bk,
                                                            **kw))
            # the pool: KV replica rk's block b is page rk * nb + b
            R_kv, s_max = cache.k.shape[:2]
            nb = s_max // bk
            rk = torch.arange(q.shape[0], device=dev) // group
            phys = (rk[:, None] * nb + tbl).int().contiguous()
            pargs = (phys, tbl, valid, cache.kv_len, q,
                     cache.k.reshape(-1, bk, hd), cache.v.reshape(-1, bk, hd),
                     cache.k_scale.reshape(-1, bk),
                     cache.v_scale.reshape(-1, bk))
            pgot = paged_attention_kernel(*pargs, **kw)
            close(pgot, paged_attention_plain(*pargs, **kw))
            assert torch.equal(pgot, got)


def test_decode_int8_oracle_scales_divide_exactly(dev, monkeypatch):
    """The int8 decode oracle (``attend_slots_state``) takes q's scale and
    each slot's p * v_scale scale as a true divide by 127 on the card, as
    JAX and the kernel do: every scale equals numpy's f32 ``x / 127`` bit
    for bit, at q rows whose max x (numpy-chosen) has x * (1 / 127) != x /
    127 in f32, and q's codes equal numpy's from those scales."""
    from sputnik_tpu_torch.ops.kernels import decode_attention as da

    rng = np.random.RandomState(7)
    hd, bk, qlen, group = 64, 32, 1, 1
    cache, tbl, valid, q = _decode_problem(dev, "int8", hd, bk, qlen, group,
                                           seed=7)
    R = q.shape[0]
    cand = (rng.rand(4096) * 4 + 0.5).astype(np.float32)
    recip = cand * np.float32(1.0 / 127.0)
    pick = cand[recip != cand / np.float32(127.0)][:R]
    assert pick.size == R
    qn = (rng.rand(R, qlen, hd).astype(np.float32) * 2 - 1) * pick[:, None,
                                                                  None]
    qn[:, :, 0] = pick[:, None]                    # each row's max |q|
    q = torch.from_numpy(qn * np.float32(8.0)).to(dev)   # q * hd**-0.5 = qn
    seen, div127 = [], da.div127

    def spy(x):
        out = div127(x)
        seen.append((x.detach().cpu().numpy(), out.detach().cpu().numpy()))
        return out

    monkeypatch.setattr(da, "div127", spy)
    da.decode_attention_plain(tbl, valid, cache.kv_len, q, cache.k, cache.v,
                              cache.k_scale, cache.v_scale, bk=bk,
                              qlen=qlen, group=group, scale=hd ** -0.5)
    assert len(seen) == 1 + tbl.shape[1]          # q once, p once a slot
    for x, out in seen:
        want = x.astype(np.float32) / np.float32(127.0)
        assert np.array_equal(out.view(np.int32), want.view(np.int32))
    x_q, qs = seen[0]
    np.testing.assert_array_equal(x_q[..., 0], np.maximum(pick[:, None],
                                                          1e-30))
    qv = q.float() * hd ** -0.5
    codes = torch.clamp(torch.round(qv / torch.from_numpy(qs).to(dev)),
                        -127, 127).cpu().numpy()
    want = np.clip(np.rint(qn / (pick[:, None, None] / np.float32(127.0))),
                   -127, 127)
    np.testing.assert_array_equal(codes, want)


@pytest.mark.parametrize("seed", range(4))
def test_decode_attention_kernel_invalid_and_empty_tables(dev, seed):
    """Random valid masks (skipped slots), block ids out of range (skipped
    too), an all-invalid replica (exactly 0), repeated block ids and head
    dims that are not a multiple of 4 (the scalar load path)."""
    from sputnik_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_kernel, decode_attention_plain)

    rng = np.random.RandomState(300 + seed)
    dtype = sorted(_CACHE_DTYPES)[seed % 3]
    hd = (30, 16, 100, 7)[seed]
    cache, _, _, q = _decode_problem(dev, dtype, hd, 32, 2, 1, seed)
    R, S = q.shape[0], 5
    nb = cache.s_max // 32
    tbl = torch.from_numpy(rng.randint(-1, nb + 2, (R, S)).astype(
        np.int32)).to(dev)                       # some ids out of range
    valid = torch.from_numpy((rng.rand(R, S) < 0.6).astype(np.int32)).to(dev)
    valid[0] = 0
    args = (tbl, valid, cache.kv_len, q, cache.k, cache.v, cache.k_scale,
            cache.v_scale)
    kw = dict(bk=32, qlen=2, group=1, scale=0.3)
    got = decode_attention_kernel(*args, **kw)
    torch.cuda.synchronize()
    _close(got, decode_attention_plain(*args, **kw))
    assert torch.all(got[0] == 0)


def _append_tokens(dev, rng, R, q, hd, dt, layout):
    """K and V tokens for the KV append: ``view``, the split views of a
    ``[2, q, R // 2, 3 * hd]`` projection folded as the decoders fold them
    (``[R, hd]`` for one token; the 16-byte path where hd allows);
    ``misaligned``, rows starting one element past a 16-byte boundary (the
    element path)."""
    if layout == "view":
        x = torch.from_numpy(rng.randn(2, q, R // 2, 3 * hd).astype(
            np.float32) * 20).to(dt).to(dev)
        out = [p.transpose(1, 2).reshape(R, q, hd)
               for p in (x[..., hd:2 * hd], x[..., 2 * hd:])]
    else:
        out = [torch.from_numpy(rng.randn(R * q * hd + 1).astype(
            np.float32) * 20).to(dt).to(dev)[1:].view(R, q, hd)
               for _ in range(2)]
    return [t[:, 0] for t in out] if q == 1 else out


def _append_against_plain(kernel, plain, bufs, args, kw):
    """One kernel call (one launch, no host sync) against the plain version
    on copies of ``bufs``, bit for bit, lengths included, on the card and
    on the CPU (whose true divide JAX's int8 scale matches: a divide by a
    Python 127.0 on the card is a multiply by its reciprocal); then the
    same call again on fresh copies gives the same bits."""
    def cpu(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    want = [b.clone() for b in bufs]
    orig = [b.clone() for b in bufs]
    ref_len = plain(*args[:2], *want, *args[2:], **kw)
    on_cpu = [b.cpu() for b in bufs]
    cpu_len = plain(*map(cpu, args[:2]), *on_cpu, *map(cpu, args[2:]),
                    **{k: cpu(v) for k, v in kw.items()})
    for c, w in zip(on_cpu + [cpu_len], want + [ref_len]):
        assert torch.equal(c.view(torch.uint8), w.cpu().view(torch.uint8))
    runs = []
    for _ in range(2):
        got = [b.clone() for b in orig]
        before = kernel.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            new_len = kernel(*args[:2], *got, *args[2:], **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        runs.append(got + [new_len])
    for got, again, ref in zip(runs[0], runs[1], want + [ref_len]):
        assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
        assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    return runs[0]


@pytest.mark.parametrize("hd", [7, 24, 64, 128, 256])
@pytest.mark.parametrize("dtype", sorted(_CACHE_DTYPES))
def test_ragged_append_kernel_bit_exact(dev, dtype, hd):
    """B21, the whole append (write rule, guarded rows, new lengths), against
    its plain version bit for bit on every contiguous route: ragged (a
    frozen slot, a full one, the last row), uniform (in range, the last row,
    at and past ``s_max``; a device scalar and a host int) and drafts of 1,
    4 and 8 (fitting, ending at ``s_max``, one past it); fp32 and bf16
    tokens, strided views and misaligned rows. Each call is one launch with
    no host sync, and gives the same bits twice."""
    from sputnik_tpu_torch.ops.kernels.ragged_append import (
        ragged_append_fused_plain, ragged_append_kernel)

    rng = np.random.RandomState(hd)
    R, s_max = 6, 96
    dt = _CACHE_DTYPES[dtype]
    kv_len = torch.tensor([0, 31, 95, 96, 40, 7], dtype=torch.int32,
                          device=dev)
    bufs = [torch.from_numpy(rng.randn(R, s_max, hd).astype(np.float32)
                             * 50).to(dt).to(dev) for _ in range(2)]
    bufs += [torch.rand(R, s_max, device=dev) for _ in range(2)]

    def at(p):
        return torch.tensor(p, dtype=torch.int32, device=dev)

    active = torch.tensor([1, 1, 0, 1, 1, 1], dtype=torch.int32, device=dev)
    cases = [(1, {}), (1, dict(active=active))]
    cases += [(1, dict(pos=at(p))) for p in (0, 40, 95, 96, 200)]
    cases += [(1, dict(pos=95))]
    cases += [(q, dict(pos=at(p), seq=True)) for q in (1, 4, 8)
              for p in (10, s_max - q, s_max - q + 1)]
    for tok_dt in (torch.float32, torch.bfloat16):
        for layout in ("view", "misaligned"):
            for q, kw in cases:
                toks = _append_tokens(dev, rng, R, q, hd, tok_dt, layout)
                got = _append_against_plain(
                    ragged_append_kernel, ragged_append_fused_plain, bufs,
                    (*toks, kv_len), kw)
                if kw == dict(active=active):     # the frozen and full slots
                    for r in (2, 3):
                        for g, b in zip(got[:4], bufs):
                            assert torch.equal(g[r].view(torch.uint8),
                                               b[r].view(torch.uint8))
                    assert got[4].tolist() == [1, 32, 95, 96, 41, 8]


def _paged_problem(dev, dtype, hd, bk, seed):
    """A pool filled through ``write_prompt_pages`` with pages allocated in
    a shuffled order: one replica near its capacity, one empty, one a few
    keys into its second block; sinks + window tables from
    ``paged_block_table`` (per KV replica). Also returns the same tokens in
    a contiguous cache."""
    from sputnik_tpu_torch.ops import decode as D
    from sputnik_tpu_torch.ops import paged as PG

    rng = np.random.RandomState(seed)
    R_kv, mb = 3, 2 if bk >= 512 else 3
    n_pages = R_kv * mb + 2
    cache, pool = PG.init_paged_cache(R_kv, n_pages, bk, hd, mb,
                                      dtype=_CACHE_DTYPES[dtype], device=dev)
    pool.free(list(rng.permutation(pool.allocate(n_pages))))
    lens = torch.tensor([mb * bk - 1, 0, bk + 3], dtype=torch.int32,
                        device=dev)
    cache = dataclasses.replace(cache, kv_len=lens)
    for r, n in enumerate(lens.tolist()):      # every replica: all mb pages
        cache = PG.ensure_pages(cache, pool, mb * bk - n, replicas=[r])
    ks, vs = (torch.from_numpy(rng.randn(R_kv, mb * bk, hd).astype(
        np.float32)).to(dev) for _ in range(2))
    cache = PG.write_prompt_pages(cache, ks, vs,
                                  replica_pages=cache.page_table.cpu(),
                                  lengths=lens)
    flat = D.prefill_kv(D.init_kv_cache(R_kv, mb * bk, hd,
                                        _CACHE_DTYPES[dtype], device=dev),
                        ks, vs, lens)
    tables = PG.paged_block_table(cache, window_blocks=2, sink_blocks=1)
    return cache, flat, tables


def _paged_args(cache, tables, q, group):
    phys, logical, valid = (t.repeat_interleave(group, 0).contiguous()
                            for t in tables)
    return (phys, logical, valid, cache.kv_len, q, cache.k, cache.v,
            cache.k_scale, cache.v_scale)


@pytest.mark.parametrize("bk", [128, 256, 384, 1024])
@pytest.mark.parametrize("hd", [7, 30, 64, 128])
@pytest.mark.parametrize("dtype", sorted(_CACHE_DTYPES))
def test_paged_attention_kernel_matches_plain(dev, dtype, hd, bk):
    """B20a against its plain version over qlen 1 / 4 / 8 and GQA group
    1 / 4 on a shuffled pool; the empty replica's rows are exactly 0, and
    the paged kernel gives B19's bits on the same tokens (the same body
    and the same key chunks; bk = 384: six chunks a page, a replica three
    keys into its second page), and its own bits twice."""
    from sputnik_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_kernel)
    from sputnik_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel, paged_attention_plain)

    cache, flat, tables = _paged_problem(dev, dtype, hd, bk, seed=hd + bk)
    assert not torch.equal(tables[0], tables[1])   # pages are not blocks
    rng = np.random.RandomState(hd)
    for qlen in (1, 4, 8):
        for group in (1, 4):
            q = torch.from_numpy(rng.randn(3 * group, qlen, hd).astype(
                np.float32)).to(dev)
            args = _paged_args(cache, tables, q, group)
            kw = dict(qlen=qlen, group=group, scale=hd ** -0.5)
            before = paged_attention_kernel.launches
            got = paged_attention_kernel(*args, **kw)
            torch.cuda.synchronize()
            assert paged_attention_kernel.launches == before + 1
            _close(got, paged_attention_plain(*args, **kw))
            assert torch.all(got[group:2 * group] == 0)
            assert torch.equal(got, paged_attention_kernel(*args, **kw))
            same = decode_attention_kernel(
                args[1], args[2], flat.kv_len, q, flat.k, flat.v,
                flat.k_scale, flat.v_scale, bk=bk, **kw)
            assert torch.equal(got, same)


@pytest.mark.parametrize("seed", range(4))
def test_paged_attention_kernel_invalid_slots_and_pages(dev, seed):
    """Random valid masks, page ids outside the pool (skipped), an
    all-invalid replica (exactly 0), repeated pages."""
    from sputnik_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel, paged_attention_plain)

    rng = np.random.RandomState(400 + seed)
    dtype = sorted(_CACHE_DTYPES)[seed % 3]
    hd = (30, 16, 100, 7)[seed]
    cache, _, tables = _paged_problem(dev, dtype, hd, 128, seed)
    R, S = 3, 5
    P = cache.k.shape[0]
    phys = torch.from_numpy(rng.randint(-2, P + 2, (R, S)).astype(
        np.int32)).to(dev)
    logical = torch.from_numpy(rng.randint(0, 3, (R, S)).astype(
        np.int32)).to(dev)
    valid = torch.from_numpy((rng.rand(R, S) < 0.7).astype(np.int32)).to(dev)
    valid[0] = 0
    q = torch.from_numpy(rng.randn(R, 2, hd).astype(np.float32)).to(dev)
    args = (phys, logical, valid, cache.kv_len, q, cache.k, cache.v,
            cache.k_scale, cache.v_scale)
    kw = dict(qlen=2, group=1, scale=0.3)
    got = paged_attention_kernel(*args, **kw)
    torch.cuda.synchronize()
    _close(got, paged_attention_plain(*args, **kw))
    assert torch.all(got[0] == 0)


@pytest.mark.parametrize("hd", [7, 24, 64, 128, 256])
@pytest.mark.parametrize("dtype", sorted(_CACHE_DTYPES))
def test_paged_append_kernel_bit_exact(dev, dtype, hd):
    """B20b, the whole append, against its plain version bit for bit: one
    token and drafts of 4 and 8 through a shuffled page table (a draft
    crossing pages, one reaching a block with no page, one past the table's
    capacity, a frozen replica, and table ids past the pool: ``P``, the
    dump page's neighbour, and ``P + 5``), fp32 and bf16 tokens, strided
    views and misaligned rows; nothing is written for a replica that does
    not fit, nor for a token whose id lies past the pool (it still counts
    as a page for the length, as in JAX's ``_resolve_write``), the dump
    page least of all. One launch, no host sync, the same bits twice."""
    from sputnik_tpu_torch.ops.kernels.paged_append import (
        paged_append_fused_plain, paged_append_kernel)

    rng = np.random.RandomState(hd + 1)
    R, P, bk, mb = 8, 10, 16, 4               # page P - 1: the dump page
    dt = _CACHE_DTYPES[dtype]
    table = np.full((R, mb), -1, np.int32)
    ids = rng.permutation(P - 1)
    for (r, blk), p in zip([(0, 0), (1, 0), (1, 1), (2, 0), (2, 1), (3, 0),
                            (4, 3), (5, 0), (7, 0)], ids):
        table[r, blk] = p
    table[6, 0] = P                           # past the pool
    table[7, 1] = P + 5
    page_table = torch.from_numpy(table).to(dev)
    lens = [3, 14, 30, 9, 64, 0, 5, 14]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    bufs = [torch.from_numpy(rng.randn(P, bk, hd).astype(np.float32)
                             * 50).to(dt).to(dev) for _ in range(2)]
    bufs += [torch.rand(P, bk, device=dev) for _ in range(2)]
    active = torch.tensor([1, 1, 1, 0, 1, 1, 1, 1], dtype=torch.int32,
                          device=dev)
    for tok_dt in (torch.float32, torch.bfloat16):
        for layout in ("view", "misaligned"):
            for q in (1, 4, 8):
                for act in (None, active):
                    toks = _append_tokens(dev, rng, R, q, hd, tok_dt, layout)
                    got = _append_against_plain(
                        paged_append_kernel, paged_append_fused_plain, bufs,
                        (*toks, page_table, kv_len), dict(active=act))
                    for g, b in zip(got[:4], bufs):
                        assert torch.equal(g[P - 1].view(torch.uint8),
                                           b[P - 1].view(torch.uint8))
                    if q == 4 and act is not None:
                        # 0 and 5 stay in their page, 1 crosses into block
                        # 1; 2 reaches block 2, which has no page; 3 is
                        # frozen; 4 is at the capacity (block 3 has a page);
                        # 6 and 7 advance, storing only 7's first two tokens
                        assert got[4].tolist() == [7, 18, 30, 9, 64, 4, 9,
                                                   18]
                        want = {int(table[r, p // bk]) * bk + p % bk
                                for r, lo, n in ((0, 3, 4), (1, 14, 4),
                                                 (5, 0, 4), (7, 14, 2))
                                for p in range(lo, lo + n)}
                        changed = set()
                        for g, b in zip(got[:4], bufs):
                            diff = (g.view(torch.uint8) != b.view(
                                torch.uint8)).reshape(P * bk, -1)
                            changed |= set(
                                diff.any(-1).nonzero()[:, 0].tolist())
                        assert changed == want


# -- the many-mask batch (B6 spmm_bh, B7 sddmm_bh, B8 spmm_t_bh) -----------

def _bh_problem(dev, tiles, heads, seed=7):
    """Three DISTINCT masks over [150, 130] (per-mask densities, an empty
    row band and an empty column band in two of them), so a replica that
    read its neighbour's metadata would read other tiles."""
    rng = np.random.RandomState(seed)
    m, n = 150, 130
    masks = np.stack([rng.rand(m, n) < d for d in (0.05, 0.2, 0.6)])
    masks[0, 40:110] = False            # empty row blocks
    masks[1, :, 20:90] = False          # empty column blocks
    masks[2, 7] = False                 # one empty row
    spec = stt.BatchedPanelSpec(
        [stt.SparseTopology.from_dense_mask(mk) for mk in masks],
        heads=heads, bm=tiles[0], bk=tiles[1])
    meta = spec.panel_meta(dev)
    R = spec.R
    panels = torch.from_numpy(rng.randn(R, *spec.panel_shape).astype(
        np.float32)).to(dev)
    panels = (panels.view(spec.B, heads, *spec.panel_shape)
              * meta["mask"][:, None]).reshape(panels.shape)
    return spec, meta, panels, rng


_BH_TILES = [(16, 16), (64, 64), (128, 128), (48, 64), (64, 48)]


@pytest.mark.parametrize("tiles", _BH_TILES)
@pytest.mark.parametrize("q", [7, 64, 640])
@pytest.mark.parametrize("heads", [1, 4])
def test_spmm_bh_kernel_matches_plain(dev, tiles, q, heads):
    spec, meta, panels, rng = _bh_problem(dev, tiles, heads)
    dense = torch.from_numpy(rng.randn(spec.R, spec.n, q).astype(
        np.float32)).to(dev)
    args = (meta["block_cols"], meta["nblocks"], panels, dense)
    before = kbp.spmm_bh_kernel.launches
    got = kbp.spmm_bh_kernel(*args, heads=heads, rows=spec.m)
    torch.cuda.synchronize()
    assert kbp.spmm_bh_kernel.launches == before + 1
    _close(got, kbp.spmm_bh_kernel_plain(*args, heads=heads, rows=spec.m))


@pytest.mark.parametrize("tiles", _BH_TILES)
@pytest.mark.parametrize("d", [7, 64, 640])
@pytest.mark.parametrize("heads", [1, 4])
def test_sddmm_bh_kernel_matches_plain_with_exact_zeros(dev, tiles, d, heads):
    spec, meta, _, rng = _bh_problem(dev, tiles, heads)
    lhs = torch.from_numpy(rng.randn(spec.R, spec.m, d).astype(
        np.float32)).to(dev)
    rhs = torch.from_numpy(rng.randn(spec.R, spec.n, d).astype(
        np.float32)).to(dev)
    args = (meta["block_cols"], meta["nblocks"], lhs, rhs, meta["mask"])
    got = kbp.sddmm_bh_kernel(*args, heads=heads)
    torch.cuda.synchronize()
    _close(got, kbp.sddmm_bh_kernel_plain(*args, heads=heads))
    off = (meta["mask"] == 0)[:, None].expand(
        spec.B, heads, *spec.panel_shape).reshape(got.shape)
    assert torch.all(got[off] == 0)     # masked + padded: exact zeros


@pytest.mark.parametrize("tiles", _BH_TILES)
@pytest.mark.parametrize("q", [7, 64, 640])
@pytest.mark.parametrize("heads", [1, 4])
def test_spmm_t_bh_kernel_matches_plain(dev, tiles, q, heads):
    spec, meta, panels, rng = _bh_problem(dev, tiles, heads)
    g = torch.from_numpy(rng.randn(spec.R, spec.m, q).astype(
        np.float32)).to(dev)
    args = (meta["t_src_i"], meta["t_src_s"], meta["t_nblocks"], panels, g)
    got = kbp.spmm_t_bh_kernel(*args, heads=heads, rows=spec.n)
    torch.cuda.synchronize()
    _close(got, kbp.spmm_t_bh_kernel_plain(*args, heads=heads, rows=spec.n))


@pytest.mark.parametrize("tiles", [(64, 64), (48, 96)])
def test_single_topology_kernels_are_the_batch_with_one_mask(dev, tiles):
    """B1 / B3 / B4 share their bodies with B6 / B7 / B8: with one mask for
    every replica (heads = R) they give the same bits."""
    rng = np.random.RandomState(9)
    m, n, q, R = 150, 170, 70, 3
    topo = stt.SparseTopology.from_dense_mask(rng.rand(m, n) < 0.1)
    pspec = stt.PanelSpec(topo, *tiles)
    meta = _meta(pspec, dev)
    bspec = stt.BatchedPanelSpec([topo], heads=R, bm=tiles[0], bk=tiles[1])
    bmeta = bspec.panel_meta(dev)
    panel = torch.from_numpy(rng.randn(R, *pspec.view.values_shape).astype(
        np.float32)).to(dev) * meta["mask"]
    dense = torch.from_numpy(rng.randn(R, n, q).astype(np.float32)).to(dev)
    assert torch.equal(
        bsr_spmm_panel(meta["block_cols"], meta["nblocks"], panel, dense,
                       rows=m),
        kbp.spmm_bh_kernel(bmeta["block_cols"], bmeta["nblocks"], panel,
                           dense, heads=R, rows=m))
    g = torch.from_numpy(rng.randn(R, m, q).astype(np.float32)).to(dev)
    assert torch.equal(
        bsr_spmm_t_panel(meta["t_src_i"], meta["t_src_s"], meta["t_nblocks"],
                         panel, g, rows=n),
        kbp.spmm_t_bh_kernel(bmeta["t_src_i"], bmeta["t_src_s"],
                             bmeta["t_nblocks"], panel, g, heads=R, rows=n))
    lhs = torch.from_numpy(rng.randn(R, m, q).astype(np.float32)).to(dev)
    assert torch.equal(
        bsr_sddmm_panel(meta["block_cols"], meta["nblocks"], lhs, dense,
                        meta["mask"]),
        kbp.sddmm_bh_kernel(bmeta["block_cols"], bmeta["nblocks"], lhs, dense,
                            bmeta["mask"], heads=R))


def test_batched_ops_train_through_the_kernels(dev):
    """The panel attention chain on distinct masks: forward and gradients
    on the card against the same ops on the CPU (plain versions), with
    launches of B6, B7 and B8."""
    b, heads, s, hd = 3, 2, 100, 32
    masks = np.stack([np.tril(np.ones((s, s), np.float32), k=-i)
                      for i in range(b)])
    masks[0, 7] = 0.0
    spec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=heads)
    rng = np.random.RandomState(4)
    cpu = [torch.from_numpy(rng.randn(b * heads, s, hd).astype(np.float32)
                            ).requires_grad_() for _ in range(3)]
    gpu = [t.detach().to(dev).requires_grad_() for t in cpu]
    cot = torch.from_numpy(rng.randn(b * heads, s, hd).astype(np.float32))

    def chain(q, k, v):
        w = stt.sparse_softmax_bh(spec, stt.sddmm_bh(spec, q, k) * 0.2)
        return stt.spmm_bh(spec, w, v)

    before = {n: w.launches for n, w in kernels.kernel_wrappers().items()}
    out = chain(*gpu)
    (out * cot.to(dev)).sum().backward()
    torch.cuda.synchronize()
    got = {n: w.launches - before[n]
           for n, w in kernels.kernel_wrappers().items()}
    assert got["spmm_bh"] == 2 and got["sddmm_bh"] == 2
    assert got["spmm_t_bh"] == 2
    ref = chain(*cpu)
    (ref * cot).sum().backward()
    _close(out.detach().cpu(), ref.detach())
    for a, r in zip(gpu, cpu):
        _close(a.grad.cpu(), r.grad)
    assert torch.all(out[:heads, 7].detach() == 0)  # mask 0's empty row


def _each_close(got, ref, scale=None):
    """Each slot within 1e-4 x ``scale`` (|plain| unless given; floored at
    f32 tiny, so an exact 0 must stay 0)."""
    scale = (ref.abs() if scale is None else scale).clamp(
        min=torch.finfo(torch.float32).tiny)
    rel = ((got - ref).abs() / scale).max().item()
    assert rel <= 1e-4, (rel, ref[ref != 0].abs().median().item())


def _same_bits_and_replays(fn, want):
    """A second call of ``fn`` and two replays of a CUDA graph that captured
    it (outputs filled with NaN before each) give ``want``'s bits."""
    assert torch.equal(fn().view(torch.int32), want.view(torch.int32))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    for _ in range(2):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))


# B5's team shapes (lanes a row, chunks a lane in registers) through the
# wrappers' measurement hook; (0, 0) is the kernel's own rule
_B5_TEAMS = [(n, v) for n in (8, 16, 32) for v in (4, 8)] + [(0, 0)]


def _refuses_other_dtypes(fn, *tensors):
    for dt in (torch.float64, torch.bfloat16):
        with pytest.raises(TypeError):
            fn(*(t.to(dt) for t in tensors))


@pytest.mark.parametrize("m,n,density,R,pad_to", [
    (64, 2000, 0.9, 1, 4),       # rows past 512 slots: the strided path
    (512, 512, 0.1, 32, 4),      # the attention shape, 32 replicas
    (200, 700, 0.74, 3, 64),     # rows either side of 512, nnz_pad > nnz
    (1, 33, 1.0, 2, 8),          # one row
])
def test_ell_softmax_kernel_matches_plain(dev, monkeypatch, m, n, density,
                                          R, pad_to):
    """B5 on CSR rows, forward and backward, against the plain versions:
    long rows (the two-pass path), an empty row, a row of -inf scores,
    replicas, padding slots (exact zeros), every team shape (8, 16, 32
    lanes a row; 4 or 8 chunks a lane in registers) and the kernel's own
    rule; one launch each, the same bits twice and after graph replays;
    f64 / bf16 operands refused."""
    from sputnik_tpu_torch.ops.kernels import ell_softmax as K
    from sputnik_tpu_torch.ops.kernels.ell_softmax import (
        ell_softmax_bwd_kernel, ell_softmax_kernel)
    from sputnik_tpu_torch.ops.plain_ops import softmax_vjp, sparse_softmax

    rng = np.random.RandomState(m + n)
    mask = rng.rand(m, n) < density
    if m > 2:
        mask[m // 2] = False                          # an empty row
    topo = stt.SparseTopology.from_dense_mask(mask, pad_to=pad_to)
    vals = (rng.randn(R, topo.nnz_pad) * 4).astype(np.float32)
    ro = topo.row_offsets
    if m > 3:
        vals[:, ro[1]:ro[2]] = -np.inf                # a row of -inf scores
        vals[:, ro[3]:ro[3] + 5] = -np.inf            # some -inf slots
    row_offsets = torch.from_numpy(ro).to(dev)
    row_ids = torch.from_numpy(topo.row_ids.astype(np.int64)).to(dev)
    v = torch.from_numpy(vals).to(dev)
    g = torch.from_numpy(rng.randn(R, topo.nnz_pad).astype(np.float32)
                         ).to(dev)
    ref = sparse_softmax(v, row_ids, row_ids < topo.m, topo.m)
    for team in _B5_TEAMS:           # the kernel's own rule last
        monkeypatch.setattr(K, "_TEAM", team)
        before = ell_softmax_kernel.launches
        got = ell_softmax_kernel(row_offsets, row_ids, v, nnz=topo.nnz)
        torch.cuda.synchronize()
        assert ell_softmax_kernel.launches == before + 1
        assert torch.isfinite(got).all()
        _close(got, ref)
        # each slot at 1e-4 x |plain|: the outputs span many magnitudes
        # below 1, where the max|plain| limit above is flat
        _each_close(got, ref)
        assert torch.all(got[:, topo.nnz:] == 0)
        if m > 3:
            assert torch.all(got[:, ro[1]:ro[2]] == 0)
    p = got
    _same_bits_and_replays(
        lambda: ell_softmax_kernel(row_offsets, row_ids, v, nnz=topo.nnz), p)

    ref = softmax_vjp(p, g, row_ids, topo.m)
    # g - rowsum(p * g) cancels where g is near the row sum: there the sum's
    # f32 rounding sets the error, so a slot's scale is |dx| + |p| x the
    # row's sum of |p * g|
    rs_abs = (p * g).abs().new_zeros(R, topo.m + 1).index_add_(
        1, row_ids, (p * g).abs()).index_select(1, row_ids)
    for team in _B5_TEAMS:           # the kernel's own rule last
        monkeypatch.setattr(K, "_TEAM", team)
        before = ell_softmax_bwd_kernel.launches
        dx = ell_softmax_bwd_kernel(row_offsets, row_ids, p, g, nnz=topo.nnz)
        torch.cuda.synchronize()
        assert ell_softmax_bwd_kernel.launches == before + 1
        _close(dx, ref)
        _each_close(dx, ref, ref.abs() + p.abs() * rs_abs)
        assert torch.all(dx[p == 0] == 0)
    _same_bits_and_replays(lambda: ell_softmax_bwd_kernel(
        row_offsets, row_ids, p, g, nnz=topo.nnz), dx)
    _refuses_other_dtypes(lambda x: ell_softmax_kernel(
        row_offsets, row_ids, x, nnz=topo.nnz), v)
    _refuses_other_dtypes(lambda a, b: ell_softmax_bwd_kernel(
        row_offsets, row_ids, a, b, nnz=topo.nnz), p, g)


def _panel_softmax_problem(dev, layout, tiles, long_rows):
    """Scores on an ELL panel with absent tiles: ``"ell"`` one mask (a
    PanelSpec's, heads = R = 3), ``"batched"`` two masks x two heads (a
    BatchedPanelSpec's). Causal masks of 200 (row blocks with absent tiles,
    so rows span them), or with ``long_rows`` a 64 x 2000 mask whose rows
    exceed the registers (the two-pass path); an emptied row, a row of -inf
    scores."""
    from sputnik_tpu_torch.many_mask import ManyMaskTopology

    rng = np.random.RandomState(sum(tiles) + long_rows)
    if long_rows:
        masks = [rng.rand(64, 2000) < d for d in (0.9, 0.5)]
    else:
        masks = [np.tril(np.ones((200, 200))) * (rng.rand(200, 200) < d)
                 for d in (1.0, 0.4)]
    for mk in masks:
        mk[7] = 0                                   # an emptied row
    if layout == "ell":
        spec = stt.PanelSpec(stt.SparseTopology.from_dense_mask(masks[0]),
                             *tiles)
        meta = spec.meta(dev)
        mask, nblocks, heads = meta["mask"][None], meta["nblocks"][None], 3
    else:
        spec = stt.BatchedPanelSpec.from_many_mask(
            ManyMaskTopology.from_dense_masks(np.stack(masks).astype(
                np.float32)), heads=2, bm=tiles[0], bk=tiles[1])
        meta = spec.panel_meta(dev)
        mask, nblocks, heads = meta["mask"], meta["nblocks"], 2
    shape = (mask.shape[0] * heads,) + tuple(mask.shape[1:])
    x = torch.from_numpy((rng.randn(*shape) * 4).astype(np.float32)).to(dev)
    x[:, 0, :, 3] = -float("inf")                   # row 3: -inf scores
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    return mask, nblocks, heads, x, g


@pytest.mark.parametrize("long_rows", [False, True])
@pytest.mark.parametrize("tiles", [(64, 64), (32, 96), (48, 48), (40, 18)])
@pytest.mark.parametrize("layout", ["ell", "batched"])
def test_panel_softmax_kernels_match_plain(dev, monkeypatch, layout, tiles,
                                           long_rows):
    """B5 on panel rows, forward and backward, against the plain versions,
    at both mask layouts (one mask for every replica; a stacked mask a
    batch element, ``heads`` replicas each): rows spanning absent tiles,
    an emptied row, a row of -inf scores (exact zeros, as at every masked
    slot), the 4-byte path (bk = 18), rows past the registers, every team
    shape; a NaN cotangent at a masked slot reaches its row as in the plain
    version; one launch each, the same bits twice and after graph replays;
    f64 / bf16 operands refused."""
    from sputnik_tpu_torch.ops.kernels import ell_softmax as K
    from sputnik_tpu_torch.ops.kernels.ell_softmax import (
        masked_softmax_plain, masked_softmax_vjp_plain,
        panel_softmax_bwd_kernel, panel_softmax_kernel)

    mask, nblocks, heads, x, g = _panel_softmax_problem(dev, layout, tiles,
                                                        long_rows)
    live = (mask != 0).repeat_interleave(heads, 0)
    assert int(nblocks.min()) < mask.shape[2] or long_rows  # absent tiles
    ref = masked_softmax_plain(x, mask, heads)
    for team in _B5_TEAMS:           # the kernel's own rule last
        monkeypatch.setattr(K, "_TEAM", team)
        before = panel_softmax_kernel.launches
        p = panel_softmax_kernel(mask, nblocks, x, heads=heads)
        torch.cuda.synchronize()
        assert panel_softmax_kernel.launches == before + 1
        assert torch.isfinite(p).all()
        _close(p, ref)
        _each_close(p, ref)
        assert torch.all(p[~live] == 0) and torch.all(p[:, 0, :, 3] == 0)
        assert torch.all(p[:, 0, :, 7] == 0)          # the emptied row
    _same_bits_and_replays(
        lambda: panel_softmax_kernel(mask, nblocks, x, heads=heads), p)

    ref = masked_softmax_vjp_plain(p, g)
    scale = ref.abs() + p.abs() * (p * g).abs().sum(
        dim=(-3, -1), keepdim=True)
    for team in _B5_TEAMS:           # the kernel's own rule last
        monkeypatch.setattr(K, "_TEAM", team)
        before = panel_softmax_bwd_kernel.launches
        dx = panel_softmax_bwd_kernel(p, g)
        torch.cuda.synchronize()
        assert panel_softmax_bwd_kernel.launches == before + 1
        _close(dx, ref)
        _each_close(dx, ref, scale)
        assert torch.all(dx[p == 0] == 0)
    _same_bits_and_replays(lambda: panel_softmax_bwd_kernel(p, g), dx)

    # a NaN cotangent at a masked slot of row 5 of row block 0, replica 0
    gn = g.clone()
    j = int((~live[0, 0, :, 5]).reshape(-1).nonzero()[0])
    gn[0, 0, j // g.shape[-1], 5, j % g.shape[-1]] = float("nan")
    got, want = (panel_softmax_bwd_kernel(p, gn),
                 masked_softmax_vjp_plain(p, gn))
    assert torch.isnan(got[0, 0, :, 5]).all()
    assert torch.isnan(want[0, 0, :, 5]).all()
    got[0, 0, :, 5] = want[0, 0, :, 5] = 0.0
    _close(got, want)
    _refuses_other_dtypes(lambda a: panel_softmax_kernel(
        mask, nblocks, a, heads=heads), x)
    _refuses_other_dtypes(lambda a, b: panel_softmax_bwd_kernel(a, b), p, g)


def test_softmax_kernels_count_no_launch_on_empty_input(dev):
    """B5's four wrappers on inputs with no slot (no replica, an empty
    ``nnz_pad``, a panel with a dimension of size 0) return empty outputs
    and leave their launch counters as they were: nothing was launched."""
    from sputnik_tpu_torch.ops.kernels.ell_softmax import (
        ell_softmax_bwd_kernel, ell_softmax_kernel, panel_softmax_bwd_kernel,
        panel_softmax_kernel)

    wr = (ell_softmax_kernel, ell_softmax_bwd_kernel, panel_softmax_kernel,
          panel_softmax_bwd_kernel)
    before = [w.launches for w in wr]
    ro = torch.zeros(3, dtype=torch.int32, device=dev)     # 2 empty rows
    ri = torch.zeros(0, dtype=torch.int64, device=dev)
    for R, nnz_pad in ((0, 4), (2, 0)):
        v = torch.zeros(R, nnz_pad, device=dev)
        ids = ri if nnz_pad == 0 else torch.full((nnz_pad,), 2, device=dev)
        assert ell_softmax_kernel(ro, ids, v, nnz=0).shape == v.shape
        assert ell_softmax_bwd_kernel(ro, ids, v, v, nnz=0).shape == v.shape
    for shape in ((0, 2, 2, 8, 8), (2, 2, 2, 0, 8), (2, 2, 0, 8, 8)):
        x = torch.zeros(shape, device=dev)
        mask = torch.zeros((1,) + shape[1:], device=dev)
        nblocks = torch.zeros(1, shape[1], dtype=torch.int32, device=dev)
        if shape[0]:
            assert panel_softmax_kernel(mask, nblocks, x,
                                        heads=shape[0]).shape == x.shape
        assert panel_softmax_bwd_kernel(x, x).shape == x.shape
    torch.cuda.synchronize()
    assert [w.launches for w in wr] == before


def test_flat_chain_trains_through_the_kernels(dev):
    """The flat attention chain (sddmm -> scale -> sparse_softmax -> spmm)
    on replicated values and a csr SparseLinear, forward and gradients on
    the card against the same calls on the CPU oracle; launches B4, B5, B1
    forward and B1, B3, B4 backward."""
    rng = np.random.RandomState(9)
    R, s, hd = 4, 300, 32
    mask = rng.rand(s, s) < 0.2
    mask[17] = False
    topo = stt.SparseTopology.from_dense_mask(mask)
    cpu = [torch.from_numpy(rng.randn(R, s, hd).astype(np.float32)
                            ).requires_grad_() for _ in range(3)]
    gpu = [t.detach().to(dev).requires_grad_() for t in cpu]
    cot = torch.from_numpy(rng.randn(R, s, hd).astype(np.float32))

    def chain(q, k, v):
        p = stt.sparse_softmax(topo, stt.sddmm(topo, q, k) * hd ** -0.5)
        return stt.spmm(topo, p, v)

    wr = kernels.kernel_wrappers()
    before = {n: w.launches for n, w in wr.items()}
    out = chain(*gpu)
    torch.cuda.synchronize()
    fwd = {n: w.launches - before[n] for n, w in wr.items()}
    assert (fwd["bsr_sddmm_panel"], fwd["ell_softmax"],
            fwd["bsr_spmm_panel"]) == (1, 1, 1)
    (out * cot.to(dev)).sum().backward()
    torch.cuda.synchronize()
    got = {n: w.launches - before[n] for n, w in wr.items()}
    assert (got["bsr_spmm_panel"], got["bsr_spmm_t_panel"],
            got["bsr_sddmm_panel"]) == (2, 2, 2)
    ref = chain(*cpu)
    (ref * cot).sum().backward()
    _close(out.detach().cpu(), ref.detach())
    for a, r in zip(gpu, cpu):
        _close(a.grad.cpu(), r.grad)
    assert torch.all(out[:, 17].detach() == 0)

    lin = stt.SparseLinear(stt.SparseTopology.from_dense_mask(
        rng.rand(96, 80) < 0.1), layout="csr")
    lin_gpu = stt.SparseLinear(lin.topology, layout="csr").to(dev)
    lin_gpu.load_state_dict(lin.state_dict())
    x = torch.from_numpy(rng.randn(3, 7, 80).astype(np.float32))
    y_cpu, y_gpu = lin(x), lin_gpu(x.to(dev))
    y_cpu.square().sum().backward()
    y_gpu.square().sum().backward()
    _close(y_gpu.detach().cpu(), y_cpu.detach())
    _close(lin_gpu.values.grad.cpu(), lin.values.grad)


# -- the int8 family (B16a, B16b, B17, B18a, B18b, B18c) ----------------------


def _int8_problem(dev, tiles, seed=0):
    """A 90%-sparse [200, 150] weight with empty row blocks at tile
    granularity, quantised on the card's tiles."""
    from sputnik_tpu_torch import int8

    rng = np.random.RandomState(seed)
    m, n = 200, 150
    mask = rng.rand(m, n) < 0.1
    mask[tiles[0]: 2 * tiles[0]] = False          # an empty row block
    topo = stt.SparseTopology.from_dense_mask(mask)
    spec = stt.PanelSpec(topo, *tiles)
    w = (mask * rng.randn(m, n)).astype(np.float32)
    panel = stt.ops.panel_api.values_to_panel_np(
        topo, stt.SparseMatrix(w).values, *tiles)
    qp = int8.quantize_panel(spec, panel).to(dev)
    return spec, qp, _meta(spec, dev), rng


@pytest.mark.parametrize("tiles", [(16, 16), (64, 64), (128, 128), (48, 48),
                                   (32, 96), (256, 256), (272, 272), (24, 20)])
@pytest.mark.parametrize("bn,q", [(128, 130), (512, 700), (1024, 1100),
                                  (48, 100), (512, 2048)])
def test_spmm_int8_kernels_match_plain(dev, tiles, bn, q):
    """B16a and B16b against their plain versions over tiles (256 and 272:
    slots of four and five 64-deep stages, whose int32 sums reach 127^2 x
    depth; bk = 20: weight rows staged byte by byte), bn and ragged widths,
    and the serving width N = 2048 at bn = 512; the empty row block is
    exactly 0; a bf16 dense operand is the f32 one upcast."""
    spec, qp, meta, rng = _int8_problem(dev, tiles)
    bm = tiles[0]
    dense = torch.from_numpy(rng.randn(150, q).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.randn(200, q).astype(np.float32)).to(dev)
    args = (meta["block_cols"], meta["nblocks"], qp.values_q, qp.scales)
    before = kbi8.bsr_spmm_panel_int8.launches
    got = kbi8.bsr_spmm_panel_int8(*args, dense, rows=200, bn=bn)
    torch.cuda.synchronize()
    assert kbi8.bsr_spmm_panel_int8.launches == before + 1
    _close(got, kbi8.bsr_spmm_panel_int8_plain(*args, dense, rows=200, bn=bn))
    assert torch.all(got[bm: 2 * bm] == 0)
    bf = dense.to(torch.bfloat16)
    _close(kbi8.bsr_spmm_panel_int8(*args, bf, rows=200, bn=bn),
           kbi8.bsr_spmm_panel_int8_plain(*args, bf.float(), rows=200, bn=bn))
    targs = (meta["t_src_i"], meta["t_src_s"], meta["t_nblocks"],
             qp.values_q, qp.scales)
    got = kbi8.bsr_spmm_t_panel_int8(*targs, g, rows=150, bq=bn)
    torch.cuda.synchronize()
    _close(got, kbi8.bsr_spmm_t_panel_int8_plain(*targs, g, rows=150, bq=bn))


@pytest.mark.parametrize("tiles", [(64, 64), (128, 128), (48, 48)])
def test_spmm_int8_kernels_same_bits_and_never_plain(dev, tiles, monkeypatch):
    """A CUDA call of B16a / B16b launches the pre-pass and the product
    (the counters move) and reaches no plain version; two calls give the
    same bits."""
    spec, qp, meta, rng = _int8_problem(dev, tiles, seed=2)
    dense = torch.from_numpy(rng.randn(150, 700).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.randn(200, 700).astype(np.float32)).to(dev)

    def refuse(*a, **k):
        raise AssertionError("a CUDA call reached a plain version")

    for name in ("bsr_spmm_panel_int8_plain", "bsr_spmm_t_panel_int8_plain",
                 "quant_kmajor_plain", "quant_tile"):
        monkeypatch.setattr(kbi8, name, refuse)
    wrappers = (kbi8.bsr_spmm_panel_int8, kbi8.bsr_spmm_t_panel_int8,
                kbi8.quant_kmajor)
    before = [w.launches for w in wrappers]
    args = (meta["block_cols"], meta["nblocks"], qp.values_q, qp.scales,
            dense)
    targs = (meta["t_src_i"], meta["t_src_s"], meta["t_nblocks"],
             qp.values_q, qp.scales, g)
    a1, a2 = (kbi8.bsr_spmm_panel_int8(*args, rows=200, bn=128)
              for _ in range(2))
    t1, t2 = (kbi8.bsr_spmm_t_panel_int8(*targs, rows=150, bq=128)
              for _ in range(2))
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [2, 2, 4]
    assert torch.equal(a1.view(torch.int32), a2.view(torch.int32))
    assert torch.equal(t1.view(torch.int32), t2.view(torch.int32))


@pytest.mark.parametrize("rows,cols,tr,tc,n_tiles", [
    (150, 700, 64, 512, 3), (200, 100, 48, 48, 5), (130, 2048, 128, 512, 2),
    (90, 33, 256, 16, 1), (17, 5, 16, 3, 2)])
def test_quant_kmajor_kernel_matches_plain(dev, rows, cols, tr, tc, n_tiles):
    """The B16a / B16b pre-pass against its plain twin: the same scales and
    the same codes byte for byte, K-major in wgmma's core-matrix order and
    zero-padded (rows past ``rows`` and past the tiles, columns past
    ``cols``)."""
    x = torch.from_numpy(np.random.RandomState(3).randn(rows, cols)
                         .astype(np.float32) * 3).to(dev)
    kp, ncols = kbi8.kmajor_plan(tr, cols)
    codes, scales = kbi8.quant_kmajor(x, tr, tc, n_tiles)
    ref_codes, ref_scales = kbi8.quant_kmajor_plain(x, tr, tc, n_tiles, kp,
                                                    ncols)
    assert codes.shape == (n_tiles, ncols // 8, kp // 16, 8, 16)
    assert torch.equal(codes, kbi8.to_core_tiles(ref_codes))
    assert torch.equal(scales, ref_scales)


@pytest.mark.parametrize("tiles", [(16, 16), (64, 64), (128, 128), (48, 48),
                                   (32, 96)])
@pytest.mark.parametrize("d", [20, 64, 128, 300])
def test_sddmm_int8_kernel_matches_plain_with_exact_zeros(dev, tiles, d):
    spec, _, meta, rng = _int8_problem(dev, tiles, seed=1)
    lhs = torch.from_numpy(rng.randn(200, d).astype(np.float32)).to(dev)
    rhs = torch.from_numpy(rng.randn(150, d).astype(np.float32)).to(dev)
    args = (meta["block_cols"], meta["nblocks"], lhs, rhs, meta["mask"])
    got = kbi8.bsr_sddmm_panel_int8(*args)
    torch.cuda.synchronize()
    _close(got, kbi8.bsr_sddmm_panel_int8_plain(*args))
    keep = torch.from_numpy(spec.view.mask).to(dev)
    assert torch.all(got[~keep] == 0)      # padded + masked: exact zeros


@pytest.mark.parametrize("tiles", [(64, 64), (128, 128), (48, 48)])
def test_sddmm_int8_kernel_same_bits_and_never_plain(dev, tiles,
                                                     monkeypatch):
    """A CUDA call of B17 (the pre-pass, then wgmma s8) adds one to its
    counter, reaches no plain version and gives the same bits twice, at
    the main path's depth 64 (two k steps of one chunk) and at 300."""
    spec, _, meta, rng = _int8_problem(dev, tiles, seed=3)

    def refuse(*a, **k):
        raise AssertionError("a CUDA call reached a plain version")

    for name in ("bsr_sddmm_panel_int8_plain", "sddmm_quant_plain",
                 "quant_tile"):
        monkeypatch.setattr(kbi8, name, refuse)
    for d in (64, 300):
        lhs = torch.from_numpy(rng.randn(200, d).astype(np.float32)).to(dev)
        rhs = torch.from_numpy(rng.randn(150, d).astype(np.float32)).to(dev)
        args = (meta["block_cols"], meta["nblocks"], lhs, rhs, meta["mask"])
        before = kbi8.bsr_sddmm_panel_int8.launches
        a1, a2 = (kbi8.bsr_sddmm_panel_int8(*args) for _ in range(2))
        torch.cuda.synchronize()
        assert kbi8.bsr_sddmm_panel_int8.launches == before + 2
        assert torch.equal(a1.view(torch.int32), a2.view(torch.int32))


@pytest.mark.parametrize("hd", [16, 64, 100, 128])
@pytest.mark.parametrize("case", ["driver", "random", "causal2048"])
def test_flash_int8_kernel_matches_plain(dev, hd, case):
    """B18a (the pre-pass, then int8 wgmma) against its plain version at
    the zero-padded head dims (16, 100) and both widths of its body, on
    the driver's masks, a random mask and the longest causal walk: the same
    bits twice, l within the limit, a fully-masked row exactly 0."""
    if case == "causal2048":
        masks, heads = _flash_masks(case)
        dead = 1000
    else:
        b, heads, s = 2, 4, 200
        masks = driver_masks(b, s)               # row s // 2 fully masked
        if case == "random":
            masks[1] *= (np.random.RandomState(2).rand(s, s) < 0.5)
        dead = s // 2
    b, s = masks.shape[:2]
    spec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=heads)
    meta = spec.flash_meta(dev)
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(b * heads, s, hd).astype(
        np.float32)).to(dev) for _ in range(3))
    args = (meta["block_cols"], meta["nblocks"], meta["mask_slot"],
            meta["is_partial"], meta["pmask"], q, k, v)
    kw = dict(heads=heads, max_bpr=meta["max_bpr"], scale=hd ** -0.5)
    out, m, l = kfi8.flash_sparse_attention_fwd_int8(*args, **kw)
    again = kfi8.flash_sparse_attention_fwd_int8(*args, **kw)
    torch.cuda.synchronize()
    for a, b_ in zip((out, m, l), again):
        assert torch.equal(a.view(torch.int32), b_.view(torch.int32))
    ref, m_ref, l_ref = kfi8.flash_sparse_attention_fwd_int8_plain(*args,
                                                                   **kw)
    _close(out, ref)
    _close(l, l_ref)
    live = l_ref > 0
    _close(m[live], m_ref[live])
    assert torch.all(out[:, dead] == 0)        # fully-masked row: exact 0
    assert torch.all(m[:, dead] == -1e30) and torch.all(l[:, dead] == 0)


def test_flash_int8_kernel_refuses_other_tiles(dev):
    masks = driver_masks(1, 128)
    spec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=1, bm=32, bk=32)
    meta = spec.flash_meta(dev)
    q = torch.zeros(1, 128, 32, device=dev)
    with pytest.raises(ValueError, match="64x64"):
        kfi8.flash_sparse_attention_fwd_int8(
            meta["block_cols"], meta["nblocks"], meta["mask_slot"],
            meta["is_partial"], meta["pmask"], q, q, q, heads=1,
            max_bpr=meta["max_bpr"], scale=1.0)


def _int8_bwd_problem(dev, hd, random_mask, seed=5):
    """The int8 backward kernels' operands: the driver's masks (row s // 2
    fully masked), keys 128-191 (one whole column block) attended by no
    query, seeded q / k / v / g and the int8 forward's out, m, l with
    D = rowsum(g * out)."""
    b, heads, s = 2, 4, 200
    masks = driver_masks(b, s)
    if random_mask:
        masks[1] *= (np.random.RandomState(2).rand(s, s) < 0.5)
    masks[:, :, 128:192] = 0.0
    spec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=heads)
    fm, bm = spec.flash_meta(dev), spec.flash_bwd_meta(dev)
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(b * heads, s, hd).astype(
        np.float32)).to(dev) for _ in range(4))
    kw = dict(heads=heads, scale=hd ** -0.5)
    out, m, l = kfi8.flash_sparse_attention_fwd_int8(
        fm["block_cols"], fm["nblocks"], fm["mask_slot"], fm["is_partial"],
        fm["pmask"], q, k, v, max_bpr=fm["max_bpr"], **kw)
    D = (g * out).sum(-1)
    ops = (q, k, v, g, m, l, D)
    rows = (fm["block_cols"], fm["nblocks"], fm["mask_slot"],
            fm["is_partial"], fm["pmask"], *ops)
    cols = (bm["t_src_i"], bm["t_nblocks"], bm["t_mask_slot"],
            bm["t_is_partial"], bm["pmask"], *ops)
    return rows, cols, dict(kw, max_bpr=fm["max_bpr"]), dict(
        kw, max_bpc=bm["max_bpc"])


@pytest.mark.parametrize("hd", [32, 64, 100, 128])
@pytest.mark.parametrize("random_mask", [False, True])
def test_flash_int8_backward_kernels_match_plain(dev, hd, random_mask):
    """B18b and B18c against their plain versions: one launch each; the
    fully-masked row's dq and an unattended column block's dk / dv are
    exactly 0; the int8 gradients are not the fp32 kernels' (B10b /
    B10c)."""
    rows, cols, rkw, ckw = _int8_bwd_problem(dev, hd, random_mask)
    dq_k, dkv_k = kfi8.flash_sparse_bwd_dq_int8, kfi8.flash_sparse_bwd_dkv_int8
    before = (dq_k.launches, dkv_k.launches)
    dq = dq_k(*rows, **rkw)
    dk, dv = dkv_k(*cols, **ckw)
    torch.cuda.synchronize()
    assert (dq_k.launches, dkv_k.launches) == (before[0] + 1, before[1] + 1)
    ref_dq = kfi8.flash_sparse_bwd_dq_int8_plain(*rows, **rkw)
    ref_dk, ref_dv = kfi8.flash_sparse_bwd_dkv_int8_plain(*cols, **ckw)
    _close(dq, ref_dq)
    _close(dk, ref_dk)
    _close(dv, ref_dv)
    assert torch.all(dq[:, 100] == 0)           # fully-masked row
    assert torch.all(dk[:, 128:192] == 0) and torch.all(dv[:, 128:192] == 0)
    f32_dq = fs.flash_sparse_bwd_dq(*rows, **rkw)
    f32_dk, _ = fs.flash_sparse_bwd_dkv(*cols, **ckw)
    for got, f32 in ((ref_dq, f32_dq), (ref_dk, f32_dk)):
        assert (got - f32).abs().max() > 10e-4 * max(1.0, got.abs().max())


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_int8_backward_causal_2048_matches_plain(dev, hd, monkeypatch):
    """B18b and B18c at the int8 example's attention (R = 8 walks of each
    of 32 row blocks, s = 2048, causal, a fully-masked row): 256 walks of 1
    to 32 tiles, past the 132 blocks that take the longest first, so the
    reversed order runs too. Against their plain versions, one counted
    launch a call, the same bits twice, the fully-masked row's dq exactly
    0; no plain version reached on the card."""
    masks, _ = _flash_masks("causal2048")
    heads, s = 8, 2048
    spec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=heads)
    fm, bm = spec.flash_meta(dev), spec.flash_bwd_meta(dev)
    rng = np.random.RandomState(9)
    q, k, v, g = (torch.from_numpy(rng.randn(heads, s, hd).astype(
        np.float32)).to(dev) for _ in range(4))
    kw = dict(heads=heads, scale=hd ** -0.5)
    out, m, l = kfi8.flash_sparse_attention_fwd_int8(
        fm["block_cols"], fm["nblocks"], fm["mask_slot"], fm["is_partial"],
        fm["pmask"], q, k, v, max_bpr=fm["max_bpr"], **kw)
    ops = (q, k, v, g, m, l, (g * out).sum(-1))
    rows = (fm["block_cols"], fm["nblocks"], fm["mask_slot"],
            fm["is_partial"], fm["pmask"], *ops)
    cols = (bm["t_src_i"], bm["t_nblocks"], bm["t_mask_slot"],
            bm["t_is_partial"], bm["pmask"], *ops)
    rkw, ckw = dict(kw, max_bpr=fm["max_bpr"]), dict(kw, max_bpc=bm["max_bpc"])
    ref_dq = kfi8.flash_sparse_bwd_dq_int8_plain(*rows, **rkw)
    ref_dk, ref_dv = kfi8.flash_sparse_bwd_dkv_int8_plain(*cols, **ckw)

    def refuse(*a, **k_):
        raise AssertionError("a CUDA call reached a plain version")

    for name in ("flash_sparse_bwd_dq_int8_plain",
                 "flash_sparse_bwd_dkv_int8_plain", "quant_tile"):
        monkeypatch.setattr(kfi8, name, refuse)
    dq_k, dkv_k = kfi8.flash_sparse_bwd_dq_int8, kfi8.flash_sparse_bwd_dkv_int8
    before = (dq_k.launches, dkv_k.launches)
    dq1, dq2 = (dq_k(*rows, **rkw) for _ in range(2))
    (dk1, dv1), (dk2, dv2) = (dkv_k(*cols, **ckw) for _ in range(2))
    torch.cuda.synchronize()
    assert (dq_k.launches, dkv_k.launches) == (before[0] + 2, before[1] + 2)
    for a, b_ in ((dq1, dq2), (dk1, dk2), (dv1, dv2)):
        assert torch.equal(a.view(torch.int32), b_.view(torch.int32))
    _close(dq1, ref_dq)
    _close(dk1, ref_dk)
    _close(dv1, ref_dv)
    assert torch.all(dq1[:, 1000] == 0)        # the fully-masked row


def test_flash_int8_backward_kernels_refuse_other_tiles(dev):
    masks = driver_masks(1, 128)
    spec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=1, bm=32, bk=32)
    fm, bm = spec.flash_meta(dev), spec.flash_bwd_meta(dev)
    x = torch.zeros(1, 128, 32, device=dev)
    st = torch.zeros(1, 128, device=dev)
    ops = (x, x, x, x, st, st, st)
    with pytest.raises(ValueError, match="64x64"):
        kfi8.flash_sparse_bwd_dq_int8(
            fm["block_cols"], fm["nblocks"], fm["mask_slot"],
            fm["is_partial"], fm["pmask"], *ops, heads=1,
            max_bpr=fm["max_bpr"], scale=1.0)
    with pytest.raises(ValueError, match="64x64"):
        kfi8.flash_sparse_bwd_dkv_int8(
            bm["t_src_i"], bm["t_nblocks"], bm["t_mask_slot"],
            bm["t_is_partial"], bm["pmask"], *ops, heads=1,
            max_bpc=bm["max_bpc"], scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_qat_int8_backward_trains_through_the_kernels(dev, dtype):
    """``attention_qat(backward="int8")`` on the card: B18a, B18b and B18c
    once each and no fp32 flash kernel; the gradients in the primals' dtype
    and equal to the CPU plain route's (``set_backend("pallas")``); the
    raw backward kernels refuse grad mode."""
    from sputnik_tpu_torch import int8

    b, heads, s, hd = 2, 4, 200, 64
    masks = driver_masks(b, s)
    spec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=heads)
    rng = np.random.RandomState(6)
    host = [torch.from_numpy(rng.randn(b * heads, s, hd).astype(np.float32))
            .to(dtype) for _ in range(4)]
    qkv = [x.to(dev).requires_grad_() for x in host[:3]]
    cot = host[3].float()
    wr = kernels.kernel_wrappers()
    before = {n: w.launches for n, w in wr.items()}
    out = int8.attention_qat(spec, *qkv, backward="int8")
    (out * cot.to(dev)).sum().backward()
    torch.cuda.synchronize()
    got = {n: w.launches - before[n] for n, w in wr.items()
           if w.launches != before[n]}
    assert got == {"flash_sparse_attention_fwd_int8": 1,
                   "flash_sparse_bwd_dq_int8": 1,
                   "flash_sparse_bwd_dkv_int8": 1}
    cpu = [x.detach().cpu().requires_grad_() for x in qkv]
    stt.set_backend("pallas")
    try:
        out_cpu = int8.attention_qat(spec, *cpu, backward="int8")
        (out_cpu * cot).sum().backward()
    finally:
        stt.set_backend("auto")
    _close(out.detach().cpu(), out_cpu.detach())
    # Limit 1e-2 x max|ref| (the W8A8 class): the CPU's exp and the
    # forward's f32 sums (so D) differ from the card's in the last place,
    # which can move a ds or p code by one step; in bf16 also one rounding
    # step (2^-8) of the gradient.
    for a, c in zip(qkv, cpu):
        assert a.grad.dtype == dtype
        err = (a.grad.cpu().float() - c.grad.float()).abs().max()
        assert err <= 1e-2 * c.grad.float().abs().max(), err
    fm = spec.flash_meta(dev)
    g = torch.zeros_like(out)
    st = torch.zeros(b * heads, fm["nblocks"].shape[1] * 64, device=dev)
    with pytest.raises(RuntimeError, match="int8.attention_qat"):
        kfi8.flash_sparse_bwd_dq_int8(
            fm["block_cols"], fm["nblocks"], fm["mask_slot"],
            fm["is_partial"], fm["pmask"], qkv[0].float(), out, out, g, st,
            st, g[..., 0], heads=heads, max_bpr=fm["max_bpr"], scale=1.0)


def test_int8_kernels_refuse_grad_mode_and_qat_trains_through_them(dev):
    from sputnik_tpu_torch import int8

    spec, qp, meta, rng = _int8_problem(dev, (64, 64), seed=4)
    dense = torch.from_numpy(rng.randn(150, 96).astype(np.float32)).to(
        dev).requires_grad_()
    with pytest.raises(RuntimeError, match="int8.spmm_qat"):
        kbi8.bsr_spmm_panel_int8(meta["block_cols"], meta["nblocks"],
                                 qp.values_q, qp.scales, dense, rows=200,
                                 bn=128)
    panel = (qp.values_q.float() * qp.scales[:, :, None, None]
             ).requires_grad_()
    wr = kernels.kernel_wrappers()
    before = {n: w.launches for n, w in wr.items()}
    cot = torch.from_numpy(rng.randn(200, 96).astype(np.float32))
    y = int8.spmm_qat(spec, panel, dense)
    (y * cot.to(dev)).sum().backward()
    torch.cuda.synchronize()
    got = {n: wr[n].launches - before[n] for n in
           ("bsr_spmm_panel_int8", "bsr_spmm_t_panel_int8",
            "bsr_sddmm_panel_int8")}
    assert got == {"bsr_spmm_panel_int8": 1, "bsr_spmm_t_panel_int8": 1,
                   "bsr_sddmm_panel_int8": 1}
    cpu_panel = panel.detach().cpu().requires_grad_()
    cpu_dense = dense.detach().cpu().requires_grad_()
    stt.set_backend("pallas")
    try:
        y_cpu = int8.spmm_qat(stt.PanelSpec(spec.topo, 64, 64), cpu_panel,
                              cpu_dense)
        (y_cpu * cot).sum().backward()
    finally:
        stt.set_backend("auto")
    _close(y.detach().cpu(), y_cpu.detach())
    _close(dense.grad.cpu(), cpu_dense.grad)
    _close(panel.grad.cpu(), cpu_panel.grad)


# -- the compressed (true-BSR) kernels B13a, B13b, B14, B15a, B15b -----------

_C_KINDS = ["skewed", "uniform", "empty_row", "all_zero"]
_C_TILES = [(32, 32), (64, 64), (64, 128)]


def _c_topology(kind, tiles):
    """A skewed band with dense rows (``test_sharded_compressed``'s shape),
    exactly one tile per row-block (the dump is never walked), a band with
    an empty row and an empty row-block, no nonzeros at all, or ("heavy")
    a row-block of 64 tiles beside a 1-tile and two empty ones."""
    bm, bk = tiles
    if kind == "heavy":      # row-block 1: 64 tiles; 2: one; 0 and 3 empty
        mask = np.zeros((4 * bm - 5, 64 * bk), bool)
        mask[bm + 3] = True
        mask[2 * bm + 1, 5] = True
        return stt.SparseTopology.from_dense_mask(mask)
    rng = np.random.RandomState(_C_KINDS.index(kind))
    if kind == "skewed":
        m, n = 320, 384
        mask = np.zeros((m, n), bool)
        for r in range(m):
            lo = max(0, r * n // m - 16)
            mask[r, lo: lo + 32] = True
        mask[[7, 140, m - 3]] = True
    elif kind == "uniform":
        m = 4 * bm
        mask = np.zeros((m, 4 * bk), bool)
        for i in range(4):
            mask[i * bm:(i + 1) * bm, i * bk:(i + 1) * bk] = (
                rng.rand(bm, bk) < 0.5)
    elif kind == "empty_row":
        m, n = 3 * bm + 5, 200
        mask = rng.rand(m, n) < 0.1
        mask[3] = False
        mask[bm: 2 * bm] = False                  # an empty row-block
    else:
        mask = np.zeros((150, 130), bool)
    return stt.SparseTopology.from_dense_mask(mask)


def _c_problem(dev, kind, tiles, R=2, seed=0):
    topo = _c_topology(kind, tiles)
    spec = stt.PanelSpec(topo, *tiles, compressed=True)
    meta = _meta(spec, dev)
    rng = np.random.RandomState(seed)
    panel = torch.from_numpy(rng.randn(R, *spec.view.values_shape).astype(
        np.float32)).to(dev) * meta["mask"]
    return topo, spec, meta, panel, rng


def _nan_filled_pool(dev, shape):
    """Leave a freed NaN-filled block of ``shape`` in the caching allocator,
    which the next allocation of that size takes: an output slot a kernel
    skips then reads NaN."""
    junk = torch.full(shape, float("nan"), device=dev)
    ptr = junk.data_ptr()
    del junk
    return ptr


def _close_each(got, ref, rtol=1e-4):
    """Each slot at ``rtol x |plain|`` (floored at f32 tiny, so an exact 0
    stays 0): softmax outputs lie far below 1."""
    scale = ref.abs().clamp(min=torch.finfo(torch.float32).tiny)
    rel = ((got - ref).abs() / scale).max().item() if ref.numel() else 0.0
    assert rel <= rtol, rel


@pytest.mark.parametrize("tiles", _C_TILES)
@pytest.mark.parametrize("kind", _C_KINDS)
@pytest.mark.parametrize("epilogue", ["none", "bias", "bias_relu"])
def test_spmm_c_kernel_matches_plain(dev, kind, tiles, epilogue):
    from sputnik_tpu_torch.ops.kernels import bsr_compressed as kc

    topo, spec, meta, panel, rng = _c_problem(dev, kind, tiles)
    R, q = panel.shape[0], 70
    dense = torch.from_numpy(rng.randn(R, topo.n, q).astype(np.float32)
                             ).to(dev)
    bias = torch.from_numpy(rng.randn(topo.m).astype(np.float32)).to(dev)
    args = (meta["block_offsets"], meta["block_cols"], panel, dense,
            None if epilogue == "none" else bias)
    before = kc.bsr_spmm_panel_c.launches
    got = kc.bsr_spmm_panel_c(*args, rows=topo.m, epilogue=epilogue,
                              plans=meta["split_plans"])
    torch.cuda.synchronize()
    assert kc.bsr_spmm_panel_c.launches == before + 1
    ref = kc.bsr_spmm_panel_c_plain(*args, rows=topo.m, epilogue=epilogue)
    _close(got, ref)
    # the walk without a split plan: one block per row-block
    _close(kc.bsr_spmm_panel_c(*args, rows=topo.m, epilogue=epilogue), ref)
    bv = spec.view
    for i in np.flatnonzero(np.diff(bv.block_offsets) == 0):
        lo, hi = i * bv.bm, min((i + 1) * bv.bm, topo.m)
        want = (torch.zeros_like(got[:, lo:hi]) if epilogue == "none"
                else bias[lo:hi, None].expand_as(got[:, lo:hi]))
        if epilogue == "bias_relu":
            want = want.clamp(min=0)
        assert torch.equal(got[:, lo:hi], want)   # no tiles: exact 0 + bias


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("width", [1, 64, 200, 640])
def test_spmm_c_kernel_split_walk(dev, bm, width):
    """B13a's split walk on one very heavy row-block (all 64 tiles of its
    row), two empty row-blocks and rows past ``M``, at widths whose plans
    cut the heavy row-block into 1-tile up to 10-tile chunks (the last one
    shorter), every epilogue: against the plain version and the unsplit
    walk, empty row-blocks exactly 0 (+ bias), the same bits twice."""
    from sputnik_tpu_torch.ops.kernels import bsr_compressed as kc

    rng = np.random.RandomState(width + bm)
    bk, R = 64, 2
    m, n = 4 * bm - 5, 64 * bk
    mask = np.zeros((m, n), bool)
    mask[bm + 3] = True                       # row-block 1: 64 tiles
    mask[2 * bm + 1, ::1000] = True           # row-block 2: 5 tiles
    topo = stt.SparseTopology.from_dense_mask(mask)
    spec = stt.PanelSpec(topo, bm, bk, compressed=True)
    meta, bv = spec.meta(dev), spec.view
    chunk = kc.split_chunk(bv.num_blocks, bv.mb, R, width, bm)
    plan = kc.split_plan(bv.block_offsets, chunk)
    assert 1 in plan["split_rows"] and chunk < 64    # the heavy one is cut
    panel = torch.from_numpy(rng.randn(R, *bv.values_shape).astype(
        np.float32)).to(dev) * meta["mask"]
    dense = torch.from_numpy(rng.randn(R, n, width).astype(np.float32)
                             ).to(dev)
    bias = torch.from_numpy(rng.randn(m).astype(np.float32)).to(dev)
    for epilogue in ("none", "bias", "bias_relu"):
        args = (meta["block_offsets"], meta["block_cols"], panel, dense,
                None if epilogue == "none" else bias)
        kw = dict(rows=m, epilogue=epilogue)
        got = kc.bsr_spmm_panel_c(*args, **kw, plans=meta["split_plans"])
        again = kc.bsr_spmm_panel_c(*args, **kw, plans=meta["split_plans"])
        torch.cuda.synchronize()
        assert torch.equal(got, again)        # no atomics: the same bits
        _close(got, kc.bsr_spmm_panel_c_plain(*args, **kw))
        _close(got, kc.bsr_spmm_panel_c(*args, **kw))
        for i in (0, 3):                      # the empty row-blocks
            lo, hi = i * bm, min((i + 1) * bm, m)
            want = (torch.zeros_like(got[:, lo:hi]) if epilogue == "none"
                    else bias[lo:hi, None].expand_as(got[:, lo:hi]))
            if epilogue == "bias_relu":
                want = want.clamp(min=0)
            assert torch.equal(got[:, lo:hi], want)


@pytest.mark.parametrize("tiles", _C_TILES)
@pytest.mark.parametrize("kind", _C_KINDS)
def test_spmm_t_c_kernel_matches_plain(dev, kind, tiles):
    from sputnik_tpu_torch.ops.kernels import bsr_compressed as kc

    topo, spec, meta, panel, rng = _c_problem(dev, kind, tiles)
    R, q = panel.shape[0], 70
    g = torch.from_numpy(rng.randn(R, topo.m, q).astype(np.float32)).to(dev)
    args = (meta["t_gblk"], meta["t_rows"], meta["t_nblocks"], panel, g)
    before = kc.bsr_spmm_t_panel_c.launches
    got = kc.bsr_spmm_t_panel_c(*args, rows=topo.n)
    torch.cuda.synchronize()
    assert kc.bsr_spmm_t_panel_c.launches == before + 1
    _close(got, kc.bsr_spmm_t_panel_c_plain(*args, rows=topo.n))
    bv = spec.view
    w = torch.zeros(R, bv.m_pad, bv.n_pad, device=dev)
    for gb in range(bv.num_blocks):       # the dense matrix of each replica
        i, c = int(bv.block_rows[gb]), int(bv.block_cols[gb])
        w[:, i * bv.bm:(i + 1) * bv.bm, c * bv.bk:(c + 1) * bv.bk] = \
            panel[:, gb]
    _close(got, (w[:, :topo.m, :topo.n].transpose(1, 2) @ g))
    t_nblocks = meta["t_nblocks"].cpu().numpy()
    for j in np.flatnonzero(t_nblocks == 0):
        assert torch.all(got[:, j * bv.bk:(j + 1) * bv.bk] == 0)


@pytest.mark.parametrize("d", [7, 100, 640])
@pytest.mark.parametrize("tiles", _C_TILES)
@pytest.mark.parametrize("kind", _C_KINDS)
def test_sddmm_c_kernel_matches_plain_with_exact_zeros(dev, kind, tiles, d):
    from sputnik_tpu_torch.ops.kernels import bsr_compressed as kc

    topo, spec, meta, panel, rng = _c_problem(dev, kind, tiles)
    R = panel.shape[0]
    lhs = torch.from_numpy(rng.randn(R, topo.m, d).astype(np.float32)
                           ).to(dev)
    rhs = torch.from_numpy(rng.randn(R, topo.n, d).astype(np.float32)
                           ).to(dev)
    args = (meta["block_rows"], meta["block_cols"], lhs, rhs, meta["mask"])
    before = kc.bsr_sddmm_panel_c.launches
    ptr = _nan_filled_pool(dev, tuple(panel.shape))
    got = kc.bsr_sddmm_panel_c(*args)
    torch.cuda.synchronize()
    assert kc.bsr_sddmm_panel_c.launches == before + 1
    print("output in the NaN-filled block:", got.data_ptr() == ptr)
    _close(got, kc.bsr_sddmm_panel_c_plain(*args))
    assert torch.all(got[:, -1] == 0)                 # the dump tile
    assert torch.all(got[:, meta["mask"] == 0] == 0)  # masked slots


def _graph_replays_equal(call, want):
    """``call()`` captured in a CUDA graph and replayed twice: each replay's
    outputs equal ``want`` bit for bit."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = call()
    outs = outs if isinstance(outs, tuple) else (outs,)
    want = want if isinstance(want, tuple) else (want,)
    for _ in range(2):
        for o in outs:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for o, w in zip(outs, want):
            assert torch.equal(o.view(torch.int32), w.view(torch.int32))


# (40, 18): rows of whole float4s neither a tile nor a row (4-byte path)
_SOFTMAX_TILES = _C_TILES + [(40, 18)]


@pytest.mark.parametrize("tiles", _SOFTMAX_TILES)
@pytest.mark.parametrize("kind", _C_KINDS + ["heavy"])
def test_softmax_c_kernels_match_plain(dev, kind, tiles, monkeypatch):
    """B15a at every chunk size of its rule (m exactly, l relatively: the
    chunk sums and their merge run in another order; a call without the
    plans raises) and B15b, each slot at 1e-4 x |plain|; a row-block of
    64 tiles beside 1-tile and empty ones; a row of -inf scores, the empty
    rows and the dump tile give exact zeros; two calls give the same bits,
    and so do two replays of a captured call (the merge counters are back
    at 0 after each)."""
    from sputnik_tpu_torch.ops.kernels import bsr_compressed as kc

    topo, spec, meta, panel, rng = _c_problem(dev, kind, tiles)
    panel = panel * 4
    bv = spec.view
    if bv.num_blocks:                       # a row of -inf scores
        i0 = int(np.flatnonzero(np.diff(bv.block_offsets))[0])
        g0, g1 = int(bv.block_offsets[i0]), int(bv.block_offsets[i0 + 1])
        ri = int(np.flatnonzero(bv.mask[g0:g1].any(axis=(0, 2)))[0])
        panel[:, g0:g1, ri] = float("-inf")
        panel = torch.where(meta["mask"] != 0, panel, 0.0)
    args = (meta["block_offsets"], panel, meta["mask"])
    plans, R = meta["split_plans"], panel.shape[0]
    m_ref, l_ref = kc.c_softmax_stats_plain(*args)
    for chunk in range(1, kc.SOFTMAX_MAX_CHUNK + 1):
        monkeypatch.setattr(kc, "softmax_chunk", lambda n, r, c=chunk: c)
        before = kc.c_softmax_stats.launches
        m, l = kc.c_softmax_stats(*args, plans=plans)
        torch.cuda.synchronize()
        assert kc.c_softmax_stats.launches == before + 1
        assert torch.equal(m, m_ref), chunk
        _close_each(l, l_ref, 1e-5)
        m2, l2 = kc.c_softmax_stats(*args, plans=plans)
        assert torch.equal(m2, m) and torch.equal(l2.view(torch.int32),
                                                  l.view(torch.int32))
        if plans[chunk]["n_parts"]:
            assert not plans.counters(R).any()
        _graph_replays_equal(lambda: kc.c_softmax_stats(*args, plans=plans),
                             (m, l))
    if kind == "heavy":
        assert plans[1]["n_parts"] == 64 and plans[3]["n_parts"] == 22
    with pytest.raises(ValueError, match="needs plans"):
        kc.c_softmax_stats(*args)
    monkeypatch.undo()
    m, l = kc.c_softmax_stats(*args, plans=plans)
    ptr = _nan_filled_pool(dev, tuple(panel.shape))
    before = kc.c_softmax_apply.launches
    got = kc.c_softmax_apply(meta["block_rows"], panel, meta["mask"], m, l)
    torch.cuda.synchronize()
    print("output in the NaN-filled block:", got.data_ptr() == ptr)
    assert kc.c_softmax_apply.launches == before + 1
    ref = kc.c_softmax_apply_plain(meta["block_rows"], panel, meta["mask"],
                                   m_ref, l_ref)
    assert torch.isfinite(got).all()
    _close(got, ref)
    _close_each(got, ref)
    assert torch.all(got[:, -1] == 0) and torch.all(got[:, meta["mask"] == 0]
                                                    == 0)
    if bv.num_blocks:
        assert torch.all(got[:, g0:g1, ri] == 0)
        assert torch.all(m[:, i0 * bv.bm + ri] == -1e30)
        assert torch.all(l[:, i0 * bv.bm + ri] == 0)
    assert torch.equal(got, kc.c_softmax_apply(meta["block_rows"], panel,
                                               meta["mask"], m, l))
    _graph_replays_equal(lambda: kc.c_softmax_apply(
        meta["block_rows"], panel, meta["mask"], m, l), got)


@pytest.mark.parametrize("tiles", _SOFTMAX_TILES)
@pytest.mark.parametrize("kind", _C_KINDS + ["heavy"])
def test_softmax_c_backward_modes_match_plain(dev, kind, tiles,
                                              monkeypatch):
    """The softmax backward's two modes on the card: the row sum of p * g
    (B15a's walk, every chunk size of its rule; without the plans it
    raises) and
    p * (g - rs[row]) (B15b's pass) against their plain versions at 1e-4;
    a cotangent that is NaN at the masked slots and the dump tile leaves
    both exact (the gradient exactly 0 there); one launch each, the same
    bits twice and after graph replays."""
    from sputnik_tpu_torch.ops.kernels import bsr_compressed as kc

    topo, spec, meta, panel, rng = _c_problem(dev, kind, tiles)
    m, l = kc.c_softmax_stats_plain(meta["block_offsets"], panel,
                                    meta["mask"])
    p = kc.c_softmax_apply_plain(meta["block_rows"], panel, meta["mask"], m,
                                 l)
    g = torch.from_numpy(rng.randn(*panel.shape).astype(np.float32)).to(dev)
    dead = meta["mask"] == 0                # the dump tile included
    g_nan = torch.where(dead, float("nan"), g)
    plans = meta["split_plans"]
    rs_ref = kc.c_softmax_rowsum_plain(meta["block_offsets"], p, g,
                                       meta["mask"])
    for chunk in range(1, kc.SOFTMAX_MAX_CHUNK + 1):
        monkeypatch.setattr(kc, "softmax_chunk", lambda n, r, c=chunk: c)
        before = kc.c_softmax_rowsum.launches
        rs = kc.c_softmax_rowsum(meta["block_offsets"], p, g_nan,
                                 meta["mask"], plans=plans)
        torch.cuda.synchronize()
        assert kc.c_softmax_rowsum.launches == before + 1
        _close(rs, rs_ref)
        assert torch.equal(rs.view(torch.int32), kc.c_softmax_rowsum(
            meta["block_offsets"], p, g_nan, meta["mask"],
            plans=plans).view(torch.int32))
        _graph_replays_equal(lambda: kc.c_softmax_rowsum(
            meta["block_offsets"], p, g_nan, meta["mask"], plans=plans), rs)
    with pytest.raises(ValueError, match="needs plans"):
        kc.c_softmax_rowsum(meta["block_offsets"], p, g_nan, meta["mask"])
    monkeypatch.undo()
    before = kc.c_softmax_grad.launches
    got = kc.c_softmax_grad(meta["block_rows"], p, g_nan, meta["mask"], rs)
    torch.cuda.synchronize()
    assert kc.c_softmax_grad.launches == before + 1
    ref = kc.c_softmax_grad_plain(meta["block_rows"], p, g, meta["mask"],
                                  rs)
    assert torch.isfinite(got).all()
    _close(got, ref)
    assert torch.all(got[:, dead] == 0)
    assert torch.equal(got, kc.c_softmax_grad(meta["block_rows"], p, g_nan,
                                              meta["mask"], rs))
    _graph_replays_equal(lambda: kc.c_softmax_grad(
        meta["block_rows"], p, g_nan, meta["mask"], rs), got)


def test_softmax_c_merge_counters_per_stream(dev):
    """B15a's merge counters are one set a (replica count, stream): calls
    on two streams at once take separate sets and all equal the plain
    version; a call under a CUDA graph's capture takes a set only the
    graph holds (none added to the plans) and its replays give the same
    statistics; every set is back at 0 after its launches."""
    from sputnik_tpu_torch.ops.kernels import bsr_compressed as kc

    topo, spec, meta, panel, rng = _c_problem(dev, "heavy", (64, 64))
    args = (meta["block_offsets"], panel, meta["mask"])
    plans, R = meta["split_plans"], panel.shape[0]
    m_ref, l_ref = kc.c_softmax_stats_plain(*args)
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(16):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(kc.c_softmax_stats(*args, plans=plans))
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    sets = [plans.merge_counters[(R, s.cuda_stream)] for s in streams]
    assert sets[0].data_ptr() != sets[1].data_ptr()
    for m, l in outs:
        assert torch.equal(m, m_ref)
        _close_each(l, l_ref, 1e-5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = dict(plans.merge_counters)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        m, l = kc.c_softmax_stats(*args, plans=plans)
    assert plans.merge_counters == before
    for _ in range(2):
        m.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(m, m_ref)
        _close_each(l, l_ref, 1e-5)
    assert not any(c.any() for c in plans.merge_counters.values())


def test_compressed_chain_trains_through_the_kernels(dev):
    """The compressed attention chain (sddmm -> sparse_softmax -> spmm)
    forward and backward on the card against the CPU: B14, B15a, B15b and
    B13a forward; B13a, B13b x 2 and B14 for the SpMM and SDDMM backward,
    and the softmax backward on B15a's and B15b's second modes (one launch
    each, no B13a; B15a's merge counters back at 0); no ELL kernel; the
    dump tile of every panel gradient exactly 0."""
    rng = np.random.RandomState(12)
    topo = _c_topology("skewed", (64, 64))
    spec = stt.PanelSpec(topo, 64, 64, compressed=True)
    s, hd = topo.m, 32
    cpu = [torch.from_numpy(rng.randn(r, hd).astype(np.float32))
           .requires_grad_() for r in (s, topo.n, topo.n)]
    gpu = [t.detach().to(dev).requires_grad_() for t in cpu]
    cot = torch.from_numpy(rng.randn(s, hd).astype(np.float32))

    def chain(q, k, v):
        w = stt.panel.sparse_softmax(spec, stt.panel.sddmm(spec, q, k)
                                     * hd ** -0.5)
        return stt.panel.spmm(spec, w, v)

    wr = kernels.kernel_wrappers()
    before = {n: w.launches for n, w in wr.items()}
    out = chain(*gpu)
    (out * cot.to(dev)).sum().backward()
    torch.cuda.synchronize()
    got = {n: w.launches - before[n] for n, w in wr.items() if
           w.launches != before[n]}
    assert got == {"bsr_sddmm_panel_c": 2, "c_softmax_stats": 1,
                   "c_softmax_apply": 1, "c_softmax_rowsum": 1,
                   "c_softmax_grad": 1, "bsr_spmm_panel_c": 2,
                   "bsr_spmm_t_panel_c": 2}, got
    counters = spec.meta(gpu[0].device)["split_plans"].merge_counters
    assert counters and not any(c.any() for c in counters.values())
    ref = chain(*cpu)
    (ref * cot).sum().backward()
    _close(out.detach().cpu(), ref.detach())
    for a, r in zip(gpu, cpu):
        _close(a.grad.cpu(), r.grad)
    panel = torch.from_numpy(rng.randn(*spec.view.values_shape).astype(
        np.float32)).to(dev).requires_grad_()
    stt.panel.spmm(spec, panel, gpu[2].detach()).square().sum().backward()
    assert torch.all(panel.grad[-1] == 0)
    assert torch.all(panel.grad[torch.from_numpy(~spec.view.mask)] == 0)


# -- the sequence-parallel layer: B2, B11a, B11b --------------------------


@pytest.mark.parametrize("seed", range(4))
def test_spmm_sel_kernel_matches_plain(dev, seed):
    """B2 on random sub-walks: a random subset of each row block's tiles,
    in a random order, against its plain version and against B1 on the
    panel with the other tiles zeroed."""
    from sputnik_tpu_torch.ops.kernels.bsr_spmm import (
        bsr_spmm_panel_sel, bsr_spmm_panel_sel_plain)

    rng = np.random.RandomState(seed)
    m, n, q = 640, 512, [64, 200, 7, 512][seed]
    mask = rng.rand(m, n) < 0.05
    topo = stt.SparseTopology.from_dense_mask(mask)
    spec = stt.PanelSpec(topo, 64, 64)
    bv = spec.view
    panel = torch.from_numpy(stt.ops.panel_api.values_to_panel_np(
        topo, stt.SparseMatrix((mask * rng.randn(m, n)).astype(
            np.float32)).values, 64, 64)).to(dev)
    sub = max(bv.max_bpr // 2, 1)
    cols = np.zeros((bv.mb, sub), np.int32)
    sel = np.zeros((bv.mb, sub), np.int32)
    nblk = np.zeros(bv.mb, np.int32)
    keep = torch.zeros(bv.mb, bv.max_bpr, dtype=torch.bool)
    for i in range(bv.mb):
        pick = rng.permutation(int(bv.nblocks[i]))[:sub]
        nblk[i] = len(pick)
        sel[i, : len(pick)] = pick
        cols[i, : len(pick)] = bv.block_cols[i, pick]
        keep[i, pick] = True
    dense = torch.from_numpy(rng.randn(n, q).astype(np.float32)).to(dev)
    args = [torch.from_numpy(x.reshape(-1)).to(dev) for x in (cols, nblk,
                                                              sel)]
    before = bsr_spmm_panel_sel.launches
    got = bsr_spmm_panel_sel(*args, panel, dense)
    torch.cuda.synchronize()
    assert bsr_spmm_panel_sel.launches == before + 1
    _close(got, bsr_spmm_panel_sel_plain(*args, panel, dense))
    meta = _meta(spec, dev)
    kept = torch.where(keep.to(dev)[:, :, None, None], panel, 0.0)
    _close(got[:m], bsr_spmm_panel(meta["block_cols"], meta["nblocks"],
                                   kept[None], dense[None], rows=m)[0])


def _ring_problem(dev, s, hd, group, zigzag, seed=3):
    part = stt.parallel.RowPartition(stt.SparseTopology.from_dense_mask(
        np.tril(np.ones((s, s), np.float32))), 4, balance=False,
        zigzag=zigzag)
    spec = stt.parallel.RingFlashSpec(part)
    rng = np.random.RandomState(seed)
    R = 2 * group
    q = torch.from_numpy((rng.randn(R, spec.m_pad_loc, hd) * hd ** -0.5)
                         .astype(np.float32)).to(dev)
    k, v = (torch.from_numpy(rng.randn(4, R // group, spec.n_loc, hd)
                             .astype(np.float32)).to(dev) for _ in range(2))
    return spec, q, k, v


def _ring_meta(spec, dev, d, band):
    meta = spec.meta(dev)
    return [meta[k][d, band] for k in ("block_cols", "nblocks", "mask_slot",
                                       "is_partial", "pmask")]


@pytest.mark.parametrize("split", [False, True], ids=["walk", "split"])
@pytest.mark.parametrize("zigzag", [False, True])
@pytest.mark.parametrize("hd,group", [(16, 1), (32, 1), (64, 1), (64, 2),
                                      (100, 1), (128, 1)])
def test_ring_band_fwd_kernel_matches_plain(dev, hd, group, zigzag, split,
                                            monkeypatch):
    """B11a carried over every band of a shard, band by band against its
    plain version (and, split, against the plain twin of the split walk),
    the same bits twice, an empty band's carry kept bit for bit, then
    finished against B9 over the whole key range with m bit-equal."""
    spec, q, k, v = _ring_problem(dev, 1024, hd, group, zigzag)
    d, R, rows = 2, q.shape[0], q.shape[1]
    _split_walk(monkeypatch, split)
    tiles = fs.flash_split_tiles(R * spec.mb, spec.max_bpr)
    assert (tiles < spec.max_bpr) == split
    acc = torch.zeros(R, rows, hd, device=dev)
    m = torch.full((R, rows), -1e30, device=dev)
    l = torch.zeros(R, rows, device=dev)
    before = fs.flash_sparse_ring_band_fwd.launches
    empty = 0
    for t in range(4):
        band = (d - t) % 4
        args = (*_ring_meta(spec, dev, d, band), q, k[band], v[band])
        carry = [x.clone() for x in (acc, m, l)]
        want = fs.flash_sparse_ring_band_fwd_plain(
            *args, *[x.clone() for x in carry], max_bpr=spec.max_bpr,
            group=group)
        got = fs.flash_sparse_ring_band_fwd(*args, acc, m, l,
                                            max_bpr=spec.max_bpr,
                                            group=group)
        again = fs.flash_sparse_ring_band_fwd(
            *args, *[x.clone() for x in carry], max_bpr=spec.max_bpr,
            group=group)
        torch.cuda.synchronize()
        assert got[0] is acc and got[1] is m and got[2] is l   # in place
        for a, b in zip(got, want):
            _close(a, b)
        for a, b in zip(got, again):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        if split:
            twin = fs.flash_sparse_ring_band_fwd_split_plain(
                *args, *carry, max_bpr=spec.max_bpr, tiles=tiles,
                group=group)
            for a, b in zip(got, twin):
                _close(a, b)
        if int(spec.nblocks[d, band].sum()) == 0:
            empty += 1
            for a, b in zip(got, carry):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert empty == (0 if zigzag else 1)
    assert fs.flash_sparse_ring_band_fwd.launches == before + 8
    k_full = spec.unshard_kv(k.cpu()).to(dev).contiguous()
    v_full = spec.unshard_kv(v.cpu()).to(dev).contiguous()
    view = spec.part.shards[d].block(64, 64)
    fm = {key: torch.from_numpy(x).to(dev) for key, x in
          fs.build_flash_meta([view]).items() if isinstance(x, np.ndarray)}
    ref, m_ref, l_ref = flash_sparse_attention_fwd(
        fm["block_cols"], fm["nblocks"], fm["mask_slot"], fm["is_partial"],
        fm["pmask"], q, k_full, v_full, heads=R, max_bpr=view.max_bpr,
        scale=1.0, group=group)
    _close(acc / l.clamp(min=1e-30)[..., None], ref)
    assert torch.equal(m, m_ref)


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_ring_band_bwd_kernel_matches_plain(dev, hd):
    """B11b over every band of a shard from random carries, band by band
    against its plain version, then against B10a over the whole key
    range."""
    spec, q, k, v = _ring_problem(dev, 1024, hd, 1, False, seed=4)
    d, R, rows = 3, q.shape[0], q.shape[1]
    acc = torch.zeros(R, rows, hd, device=dev)
    m = torch.full((R, rows), -1e30, device=dev)
    l = torch.zeros(R, rows, device=dev)
    for t in range(4):
        band = (d - t) % 4
        fs.flash_sparse_ring_band_fwd(*_ring_meta(spec, dev, d, band), q,
                                      k[band], v[band], acc, m, l,
                                      max_bpr=spec.max_bpr)
    out = acc / l.clamp(min=1e-30)[..., None]
    g = torch.randn_like(q)
    D = (g * out).sum(-1)
    dq = torch.zeros_like(q)
    dks, dvs = torch.zeros_like(k), torch.zeros_like(v)
    before = fs.flash_sparse_ring_band_bwd.launches
    for t in range(4):
        band = (d - t) % 4
        args = (*_ring_meta(spec, dev, d, band), q, k[band], v[band], g, m,
                l, D)
        want = fs.flash_sparse_ring_band_bwd_plain(
            *args, dq.clone(), dks[band].clone(), dvs[band].clone(),
            max_bpr=spec.max_bpr)
        got = fs.flash_sparse_ring_band_bwd(*args, dq, dks[band], dvs[band],
                                            max_bpr=spec.max_bpr)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            _close(a, b)
    assert fs.flash_sparse_ring_band_bwd.launches == before + 4
    view = spec.part.shards[d].block(64, 64)
    fm = {key: torch.from_numpy(x).to(dev) for key, x in
          fs.build_flash_meta([view]).items() if isinstance(x, np.ndarray)}
    k_full, v_full = (spec.unshard_kv(x.cpu()).to(dev).contiguous()
                      for x in (k, v))
    rq, rk, rv = fs.flash_sparse_bwd_fused(
        fm["block_cols"], fm["nblocks"], fm["mask_slot"], fm["is_partial"],
        fm["pmask"], q, k_full, v_full, g, m, l, D, heads=R,
        max_bpr=view.max_bpr, scale=1.0)
    _close(dq, rq)
    _close(spec.unshard_kv(dks.cpu()), rk.cpu())
    _close(spec.unshard_kv(dvs.cpu()), rv.cpu())


@pytest.mark.parametrize("group", [1, 2])
def test_ring_flash_attention_trains_through_the_kernels(dev, group):
    """ring_flash_attention forward and backward on the card against the
    CPU: ndev^2 launches of B11a, and of B11b (group 1) or of B10b and
    B10c (group 2)."""
    s, hd, R = 1024, 64, 2 * group
    part = stt.parallel.RowPartition(stt.SparseTopology.from_dense_mask(
        np.tril(np.ones((s, s), np.float32))), 4, zigzag=True)
    spec = stt.parallel.RingFlashSpec(part)
    rng = np.random.RandomState(group)
    cpu = [spec.shard_queries(torch.from_numpy(rng.randn(R, s, hd).astype(
        np.float32))).contiguous().requires_grad_()]
    cpu += [spec.shard_keys(torch.from_numpy(rng.randn(R // group, s, hd)
                                             .astype(np.float32)))
            .contiguous().requires_grad_() for _ in range(2)]
    gpu = [t.detach().to(dev).requires_grad_() for t in cpu]
    wr = kernels.kernel_wrappers()
    before = {n: w.launches for n, w in wr.items()}
    out = stt.parallel.ring_flash_attention(spec, *gpu, group=group)
    out.square().sum().backward()
    torch.cuda.synchronize()
    got = {n: w.launches - before[n] for n, w in wr.items()
           if w.launches != before[n]}
    bwd = ({"flash_sparse_ring_band_bwd": 16} if group == 1 else
           {"flash_sparse_bwd_dq": 16, "flash_sparse_bwd_dkv": 16})
    assert got == {"flash_sparse_ring_band_fwd": 16, **bwd}, got
    ref = stt.parallel.ring_flash_attention(spec, *cpu, group=group)
    ref.square().sum().backward()
    _close(out.detach().cpu(), ref.detach())
    for a, r in zip(gpu, cpu):
        _close(a.grad.cpu(), r.grad)


@pytest.mark.parametrize("case", ["split", "ragged", "gathered"])
def test_sharded_spmm_halo_trains_through_the_kernels(dev, case):
    """sharded_spmm_halo forward and backward on the card against the CPU,
    in its three branches: B2 x 2 a shard (split) or B1 (ragged,
    gathered) forward, B4 + B3 a shard backward."""
    rng = np.random.RandomState(5)
    n, ndev = 1024, 4
    if case == "gathered":
        A = ((rng.rand(n, n) < 0.05) * rng.randn(n, n)).astype(np.float32)
    else:
        rows = np.arange(n)[:, None] - np.arange(n)[None, :]
        A = ((rows >= 0) & (rows < 96)) * rng.randn(n, n).astype(np.float32)
    n_loc = n // ndev if case != "ragged" else None
    if case == "ragged":
        A = A[:1000, :1000]
        n = 1000
        n_loc = n // ndev                       # 250: not whole 64-blocks
    mat = stt.SparseMatrix(A.astype(np.float32))
    part = stt.parallel.RowPartition(mat.topology, ndev,
                                     balance=case == "gathered")
    spec = stt.parallel.ShardedPanelSpec(part)
    from sputnik_tpu_torch.parallel.sharded_ops import _halo_plan
    plan = _halo_plan(spec, n_loc)
    assert (plan is None) == (case == "gathered")
    assert (n_loc % 64 == 0) == (case != "ragged")
    cpu = [torch.from_numpy(spec.stack_values(mat.values)).requires_grad_(),
           torch.from_numpy(rng.randn(ndev, n_loc, 96).astype(np.float32))
           .requires_grad_()]
    gpu = [t.detach().to(dev).requires_grad_() for t in cpu]
    wr = kernels.kernel_wrappers()
    before = {nm: w.launches for nm, w in wr.items()}
    out = stt.parallel.sharded_spmm_halo(spec, *gpu)
    out.square().sum().backward()
    torch.cuda.synchronize()
    got = {nm: w.launches - before[nm] for nm, w in wr.items()
           if w.launches != before[nm]}
    fwd = ({"bsr_spmm_panel_sel": 2 * ndev} if case == "split"
           else {"bsr_spmm_panel": ndev})
    assert got == {**fwd, "bsr_sddmm_panel": ndev,
                   "bsr_spmm_t_panel": ndev}, got
    ref = stt.parallel.sharded_spmm_halo(spec, *cpu)
    ref.square().sum().backward()
    _close(out.detach().cpu(), ref.detach())
    for a, r in zip(gpu, cpu):
        _close(a.grad.cpu(), r.grad)


@pytest.mark.parametrize("compressed", [False, True])
def test_bf16_panel_operands_launch_the_f32_kernels(dev, compressed):
    """bf16 (and mixed) operands of stt.panel.spmm / sddmm cast to f32 at
    the op's boundary: one launch of the f32 kernel each, the promoted
    dtype out, gradients in their primals' dtypes."""
    rng = np.random.RandomState(9)
    mask = rng.rand(256, 192) < 0.1
    topo = stt.SparseTopology.from_dense_mask(mask)
    spec = stt.PanelSpec(topo, 64, 64, compressed=compressed)
    panel = stt.panel.panel_kaiming_values(
        topo, 64, 64, compressed=compressed).to(dev).bfloat16()
    dense = torch.randn(192, 32, device=dev).bfloat16()
    lhs = torch.randn(256, 32, device=dev)
    spmm_k, sddmm_k = (("bsr_spmm_panel_c", "bsr_sddmm_panel_c")
                       if compressed else
                       ("bsr_spmm_panel", "bsr_sddmm_panel"))
    wr = kernels.kernel_wrappers()
    before = {n: w.launches for n, w in wr.items()}
    out = stt.panel.spmm(spec, panel, dense)
    scores = stt.panel.sddmm(spec, lhs, dense)
    torch.cuda.synchronize()
    got = {n: w.launches - before[n] for n, w in wr.items()
           if w.launches != before[n]}
    assert got == {spmm_k: 1, sddmm_k: 1}, got
    assert out.dtype == torch.bfloat16 and scores.dtype == torch.float32
    ref = stt.panel.spmm(spec, panel.float().cpu(), dense.float().cpu())
    err = (out.float().cpu() - ref).abs().max().item()
    assert err <= 2e-2 * max(1.0, ref.abs().max().item()), err
    layer = stt.SparseLinear(topo, dtype=torch.bfloat16, device=dev)
    x = torch.randn(5, 192, device=dev, requires_grad=True)
    y = layer(x)
    y.sum().backward()
    assert y.dtype == torch.float32 and layer.values.grad.dtype == \
        torch.bfloat16 and x.grad.dtype == torch.float32


# -- the fp32 SpMMs on the tensor cores (B1, B3, B6, B8 in split TF32) -----

_TC_KINDS = ["B1", "B3", "B6", "B8"]


def _tc_case(dev, kind, seed=11):
    """A 4096-deep contraction: row block 0 (B1, B6) or block column 0 (B3,
    B8) holds 64 full 64 x 64 tiles, the other row block / column 5% of its
    elements; two replicas, 200 output columns. Returns ``call(meta,
    panel, x)``, the metadata, the panel, x, the count to empty and its
    outputs' rows."""
    rng = np.random.RandomState(seed)
    K, q, R = 4096, 200, 2
    mask = np.zeros((128, K), bool)
    mask[:64] = True
    mask[64:] = rng.rand(64, K) < 0.05
    if kind in ("B3", "B8"):
        mask = mask.T
    m, n = mask.shape
    topo = stt.SparseTopology.from_dense_mask(mask)
    if kind in ("B1", "B3"):
        spec = stt.PanelSpec(topo, 64, 64)
        meta, shape = _meta(spec, dev), spec.view.values_shape
        keep = meta["mask"]
    else:
        spec = stt.BatchedPanelSpec([topo], heads=R, bm=64, bk=64)
        meta = dict(spec.panel_meta(dev))
        shape, keep = spec.panel_shape, meta["mask"][0]
    panel = torch.from_numpy(rng.randn(R, *shape).astype(np.float32)).to(
        dev) * keep
    x = torch.from_numpy(rng.randn(R, n if kind in ("B1", "B6") else m,
                                   q).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.randn(m).astype(np.float32)).to(dev)
    calls = {
        "B1": lambda md, p, x: bsr_spmm_panel(
            md["block_cols"], md["nblocks"], p, x, bias, rows=m,
            epilogue="bias"),
        "B3": lambda md, p, x: bsr_spmm_t_panel(
            md["t_src_i"], md["t_src_s"], md["t_nblocks"], p, x, rows=n),
        "B6": lambda md, p, x: kbp.spmm_bh_kernel(
            md["block_cols"], md["nblocks"], p, x, heads=R, rows=m),
        "B8": lambda md, p, x: kbp.spmm_t_bh_kernel(
            md["t_src_i"], md["t_src_s"], md["t_nblocks"], p, x, heads=R,
            rows=n),
    }
    plains = {"B1": bsr_spmm_panel_plain, "B3": bsr_spmm_t_panel_plain,
              "B6": kbp.spmm_bh_kernel_plain,
              "B8": kbp.spmm_t_bh_kernel_plain}
    count = "nblocks" if kind in ("B1", "B6") else "t_nblocks"
    return calls[kind], plains[kind], meta, panel, x, count, (
        bias if kind == "B1" else None)


def _f64_reference(kind, plain, meta, panel, x, bias):
    """The plain version in float64 on the card: the exact product up to
    f64 rounding."""
    args = {"B1": ("block_cols", "nblocks"), "B6": ("block_cols", "nblocks"),
            "B3": ("t_src_i", "t_src_s", "t_nblocks"),
            "B8": ("t_src_i", "t_src_s", "t_nblocks")}[kind]
    md = [meta[a] for a in args]
    p, x = panel.double(), x.double()
    if kind == "B1":
        return plain(*md, p, x, bias.double(), rows=128, epilogue="bias")
    if kind == "B3":
        return plain(*md, p, x, rows=128)
    return plain(*md, p, x, heads=2, rows=128)


@pytest.mark.parametrize("kind", _TC_KINDS)
def test_spmm_tc_deep_contraction_against_f64(dev, kind):
    """Split TF32 over a 4096-deep walk stays within 1e-5 * max|f64| (the
    tensor cores' sums are promoted into f32 sums once a slot), 10x inside
    the kernels' limit; one TF32 pass could not (test_torch_tf32_split)."""
    call, plain, meta, panel, x, _, bias = _tc_case(dev, kind)
    got = call(meta, panel, x)
    torch.cuda.synchronize()
    ref = _f64_reference(kind, plain, meta, panel, x, bias)
    err = (got.double() - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.parametrize("kind", _TC_KINDS)
def test_spmm_tc_same_bits_and_never_plain(dev, kind, monkeypatch):
    """A CUDA call launches the tensor-core kernel (the counter moves by
    one a call) and reaches no plain version; two calls give the same
    bits (no float atomics)."""
    call, _, meta, panel, x, _, _ = _tc_case(dev, kind)

    def refuse(*a, **k):
        raise AssertionError("a CUDA call reached a plain version")

    monkeypatch.setattr(kbp, "spmm_bh_kernel_plain", refuse)
    monkeypatch.setattr(kbp, "spmm_t_bh_kernel_plain", refuse)
    import sputnik_tpu_torch.ops.kernels.bsr_spmm as kb1
    import sputnik_tpu_torch.ops.kernels.bsr_spmm_t as kb3
    monkeypatch.setattr(kb1, "bsr_spmm_panel_plain", refuse)
    monkeypatch.setattr(kb3, "bsr_spmm_t_panel_plain", refuse)
    wrapper = {"B1": bsr_spmm_panel, "B3": bsr_spmm_t_panel,
               "B6": kbp.spmm_bh_kernel, "B8": kbp.spmm_t_bh_kernel}[kind]
    before = wrapper.launches
    a, b = call(meta, panel, x), call(meta, panel, x)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("kind", _TC_KINDS)
def test_spmm_tc_emptied_walk_is_exact_zero(dev, kind):
    """The deep row block (block column) emptied by setting its count to 0
    writes exactly 0 (B1: exactly its bias); the others keep their bits."""
    call, _, meta, panel, x, count, bias = _tc_case(dev, kind)
    full = call(meta, panel, x)
    md = dict(meta)
    md[count] = meta[count].clone()
    md[count][..., 0] = 0
    got = call(md, panel, x)
    torch.cuda.synchronize()
    want = (torch.zeros_like(got[:, :64]) if bias is None else
            bias[:64, None].expand_as(got[:, :64]))
    assert torch.equal(got[:, :64], want)
    assert torch.equal(got[:, 64:].view(torch.int32),
                       full[:, 64:].view(torch.int32))


# -- the SDDMM body (B4, B7, B14) and the column walk (B10c) on the tensor
#    cores, in split TF32

def _sddmm_case(dev, kind, d=640):
    """``(call, wrapper, plain, args)`` of one SDDMM body at depth ``d``:
    B4 on one topology with a padded slot, B7 on three distinct masks, B14
    on a compressed panel whose row blocks hold odd and even tile counts."""
    from sputnik_tpu_torch.ops.kernels import bsr_compressed as kc
    from sputnik_tpu_torch.ops.kernels import bsr_sddmm as k4

    rng = np.random.RandomState(17)
    if kind == "B7":
        spec, meta, _, rng = _bh_problem(dev, (64, 64), 2, seed=17)
        m, n, R = spec.m, spec.n, spec.R
        args = [meta["block_cols"], meta["nblocks"], None, None,
                meta["mask"]]
        mod, name = kbp, "sddmm_bh_kernel"
        kw = dict(heads=2)
    else:
        m, n, R = 300, 260, 2
        mask = rng.rand(m, n) < 0.1
        mask[70:130] = False                  # an empty row block
        topo = stt.SparseTopology.from_dense_mask(mask)
        spec = stt.PanelSpec(topo, 64, 64, compressed=kind == "B14")
        meta = _meta(spec, dev)
        if kind == "B4":
            args = [meta["block_cols"], meta["nblocks"], None, None,
                    meta["mask"]]
            mod, name = k4, "bsr_sddmm_panel"
        else:
            args = [meta["block_rows"], meta["block_cols"], None, None,
                    meta["mask"]]
            mod, name = kc, "bsr_sddmm_panel_c"
        kw = {}
    args[2] = torch.from_numpy(rng.randn(R, m, d).astype(np.float32)).to(dev)
    args[3] = torch.from_numpy(rng.randn(R, n, d).astype(np.float32)).to(dev)
    wrapper = getattr(mod, name)
    plain = getattr(mod, name + "_plain")
    return (lambda: wrapper(*args, **kw)), wrapper, (mod, name + "_plain"), \
        lambda: plain(*(x.double() if x.is_floating_point() else x
                        for x in args), **kw)


@pytest.mark.parametrize("kind", ["B4", "B7", "B14"])
def test_sddmm_tc_deep_same_bits_and_never_plain(dev, kind, monkeypatch):
    """B4 / B7 / B14 on the tensor cores at depth 640 (the MoE bank's
    capacity) within 1e-5 * max|f64| of a float64 plain run, 10x inside
    the kernels' limit; two calls give the same bits; a CUDA call moves the
    launch counter by one and reaches no plain version."""
    call, wrapper, (mod, plain_name), ref64 = _sddmm_case(dev, kind)
    ref = ref64()

    def refuse(*a, **k):
        raise AssertionError("a CUDA call reached a plain version")

    monkeypatch.setattr(mod, plain_name, refuse)
    before = wrapper.launches
    a, b = call(), call()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    err = (a.double() - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), (err, ref.abs().max().item())
    assert torch.all(a[ref == 0] == 0)   # masked, padded, dump: exact zeros


@pytest.mark.parametrize("split", [False, True], ids=["walk", "split"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("group", [1, 2])
def test_flash_dkv_tc_same_bits_and_never_plain(dev, hd, group, split,
                                                monkeypatch):
    """B10c on the tensor cores, whole and split into chunks (merged in
    chunk order): within the kernels' limit of its plain version, the same
    bits twice, key columns no query attends exactly 0, one launch a call
    and no plain version reached."""
    _split_walk(monkeypatch, split)
    b, heads, s = 2, 4, 200
    spec, ops, kw = _bwd_problem(dev, b, heads, s, hd, group, seed=hd * group)
    bm = spec.flash_bwd_meta(dev)
    targs = (bm["t_src_i"], bm["t_nblocks"], bm["t_mask_slot"],
             bm["t_is_partial"], bm["pmask"], *ops)
    ref = fs.flash_sparse_bwd_dkv_plain(*targs, max_bpc=bm["max_bpc"], **kw)

    def refuse(*a, **k):
        raise AssertionError("a CUDA call reached a plain version")

    monkeypatch.setattr(fs, "flash_sparse_bwd_dkv_plain", refuse)
    before = fs.flash_sparse_bwd_dkv.launches
    got = fs.flash_sparse_bwd_dkv(*targs, max_bpc=bm["max_bpc"], **kw)
    again = fs.flash_sparse_bwd_dkv(*targs, max_bpc=bm["max_bpc"], **kw)
    torch.cuda.synchronize()
    assert fs.flash_sparse_bwd_dkv.launches == before + 2
    tiles = fs.flash_split_tiles((spec.R // group) * spec.kb,
                                 group * bm["max_bpc"])
    assert (tiles < group * bm["max_bpc"]) == split
    for a, r, a2 in zip(got, ref, again):
        _close(a, r)
        assert torch.equal(a.view(torch.int32), a2.view(torch.int32))
    dead = slice(s // 3 + 6, s // 3 + 64)         # no query of mask 1 reads
    rk = heads // group                           # first KV replica of b=1
    assert torch.all(got[0][rk:, dead] == 0) and torch.all(
        got[1][rk:, dead] == 0)
