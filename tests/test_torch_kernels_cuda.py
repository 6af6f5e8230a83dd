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


@pytest.mark.parametrize("hd", [32, 64, 100, 128])
@pytest.mark.parametrize("group", [1, 2])
def test_flash_backward_kernels_match_plain(dev, hd, group):
    """B10a / B10b / B10c against their plain versions: s = 200 (not a
    multiple of 64), a fully-masked row (dq exactly 0) and key columns no
    query attends (dk = dv = 0)."""
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


@pytest.mark.parametrize("bk", [8, 32, 1024])
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("dtype", sorted(_CACHE_DTYPES))
def test_decode_attention_kernel_matches_plain(dev, dtype, hd, bk):
    """B19 against its plain version over qlen 1 / 4 / 8 and GQA group
    1 / 2 / 4; the empty replica's rows are exactly 0."""
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


@pytest.mark.parametrize("hd", [7, 64, 128])
@pytest.mark.parametrize("dtype", sorted(_CACHE_DTYPES))
def test_ragged_append_kernel_bit_exact(dev, dtype, hd):
    """B21 against its plain version, bit for bit: a frozen slot, a full
    slot and a write at the last row keep every other byte as it was."""
    from sputnik_tpu_torch.ops.kernels.ragged_append import (
        ragged_append_kernel, ragged_append_plain)

    rng = np.random.RandomState(hd)
    R, s_max = 6, 96
    dt = _CACHE_DTYPES[dtype]

    def rand(*shape):
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 50)
        return x.to(dt).to(dev)

    pos = torch.tensor([0, 31, 32, 95, 96, 40], dtype=torch.int32,
                       device=dev)
    ok = torch.tensor([1, 1, 0, 1, 1, 1], dtype=torch.int32, device=dev)
    bufs = [rand(R, s_max, hd), rand(R, s_max, hd),
            torch.rand(R, s_max, device=dev), torch.rand(R, s_max, device=dev)]
    toks = (rand(R, hd), rand(R, hd), torch.rand(R, device=dev),
            torch.rand(R, device=dev))
    orig = [b.clone() for b in bufs]
    want = [b.clone() for b in bufs]
    ragged_append_plain(pos, ok, *toks, *want)
    before = ragged_append_kernel.launches
    ragged_append_kernel(pos, ok, *toks, *bufs)
    torch.cuda.synchronize()
    assert ragged_append_kernel.launches == before + 1
    for got, ref, old in zip(bufs, want, orig):
        assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
        # the frozen slot (2) and the full one (4) keep every byte
        for r in (2, 4):
            assert torch.equal(got[r].view(torch.uint8),
                               old[r].view(torch.uint8))
    assert torch.equal(bufs[0][3, 95], toks[0][3])
