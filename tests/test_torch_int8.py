"""The int8 (W8A8) serving family of the PyTorch port on the CPU against the
JAX package's ``sputnik_tpu.int8``.

Each case makes its inputs with numpy from a seed and runs both packages
with the same ``(bm, bk, bn)``: under ``set_backend("pallas")`` the port
runs its kernels' plain versions and JAX its Pallas kernels in interpret
mode, on the same quantisation grid; ``"auto"`` and ``"xla"`` run JAX's
off-TPU fp32 route in both. Tolerances: the quantised arrays exactly; the
SpMM family 1e-5 x max|ref| (the integer products are exact, only the f32
rescale sums differ in order); attention 1e-4 x max|ref| (the f32 softmax,
and exp in another implementation, which could move one rounded p).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu import int8 as jq8
from sputnik_tpu import many_mask as jmm
from sputnik_tpu.ops import batched_panel as jbp
from sputnik_tpu.ops import panel_api as JP
from sputnik_tpu_torch import bridge
from sputnik_tpu_torch import int8 as tq8
from sputnik_tpu_torch.ops import panel_api as TP
from sputnik_tpu_torch.ops.batched_panel import BatchedPanelSpec
from sputnik_tpu_torch.ops.fused_attention import fused_sparse_attention

M, K, Q = 96, 80, 48
TILE = 16


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - ref).max() if ref.size else 0.0
    bound = rtol * max(np.abs(ref).max() if ref.size else 0.0, 1e-30)
    assert err <= bound, (err, bound)


class _backend:
    """Both packages' ``set_backend`` for the block, reset in a finally."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        st.set_backend(self.name)
        stt.set_backend(self.name)

    def __exit__(self, *exc):
        st.set_backend("auto")
        stt.set_backend("auto")


def _matrix(seed=10, m=M, k=K, density=0.3):
    rng = np.random.RandomState(seed)
    a = ((rng.rand(m, k) < density) * rng.randn(m, k)).astype(np.float32)
    a[5] = 0.0                                  # an empty row block slice
    return a, rng


def _specs(a, bn=None):
    jm, tm = st.SparseMatrix(a), stt.SparseMatrix(a)
    jspec = JP.PanelSpec(jm.topology, bm=TILE, bk=TILE, bn=bn)
    tspec = TP.PanelSpec(tm.topology, bm=TILE, bk=TILE, bn=bn)
    panel = JP.values_to_panel_np(jm.topology, jm.values, TILE, TILE)
    return jspec, tspec, panel


def test_quantized_arrays_equal_jax():
    """quantize_panel, the in-graph quantiser and the bridge give JAX's
    arrays byte for byte."""
    a, _ = _matrix()
    jspec, tspec, panel = _specs(a)
    jqp = jq8.quantize_panel(jspec, panel)
    tqp = tq8.quantize_panel(tspec, panel)
    np.testing.assert_array_equal(tqp.values_q.numpy(),
                                  np.asarray(jqp.values_q))
    np.testing.assert_array_equal(tqp.scales.numpy(), np.asarray(jqp.scales))
    assert tqp.values_q.dtype == torch.int8
    assert tqp.scales.dtype == torch.float32
    jg = jq8.quantize_panel_jnp(jnp.asarray(panel))
    tg = tq8.quantize_panel_tensor(torch.from_numpy(panel))
    np.testing.assert_array_equal(tg.values_q.numpy(), np.asarray(jg.values_q))
    np.testing.assert_array_equal(tg.scales.numpy(), np.asarray(jg.scales))
    bq = bridge.quantized_panel(np.asarray(jqp.values_q),
                                np.asarray(jqp.scales))
    assert torch.equal(bq.values_q, tqp.values_q)
    assert torch.equal(bq.scales, tqp.scales)
    moved = bq.to("cpu")
    assert isinstance(moved, tq8.QuantizedPanel)
    with pytest.raises(ValueError, match="int8"):
        bridge.quantized_panel(np.asarray(jqp.scales), np.asarray(jqp.scales))


def test_panel_spec_bn_slot():
    a, _ = _matrix()
    jspec, tspec, _ = _specs(a, bn=32)
    assert tspec.bn == jspec.bn == 32
    assert "bn=32" in repr(tspec)
    assert TP.PanelSpec(tspec.topo).bn is None


@pytest.mark.parametrize("bn,q", [(None, Q), (32, Q), (None, 200),
                                  (16, 40)])
def test_spmm_family_matches_jax(bn, q):
    """spmm_int8 / spmm_t_int8 on JAX's grid: bn set or by the width rule,
    ragged last column tiles (48 of 128, 16 of 32, 200 of 2 x 128)."""
    a, rng = _matrix()
    jspec, tspec, panel = _specs(a, bn)
    jqp = jq8.quantize_panel(jspec, panel)
    tqp = tq8.quantize_panel(tspec, panel)
    dense = rng.randn(K, q).astype(np.float32)
    g = rng.randn(M, q).astype(np.float32)
    with _backend("pallas"):
        jout = jq8.spmm_int8(jspec, jqp, jnp.asarray(dense))
        joutt = jq8.spmm_t_int8(jspec, jqp, jnp.asarray(g))
        tout = tq8.spmm_int8(tspec, tqp, torch.from_numpy(dense))
        toutt = tq8.spmm_t_int8(tspec, tqp, torch.from_numpy(g))
    _close(tout, jout, 1e-5)
    _close(toutt, joutt, 1e-5)
    # W8A8 error against fp32, and not fp32 itself
    rel = np.abs(tout.numpy() - a @ dense).max() / np.abs(a @ dense).max()
    assert 1e-4 < rel < 5e-2, rel


@pytest.mark.parametrize("rows,cols,tr,tc,n_tiles", [
    (80, 48, 16, 16, 5), (150, 700, 64, 512, 3), (200, 100, 48, 48, 5),
    (90, 33, 256, 16, 1), (17, 5, 16, 3, 2)])
def test_kmajor_codes_match_quant_tile(rows, cols, tr, tc, n_tiles):
    """The B16a / B16b pre-pass's plain twin against ``quant_tile`` (whose
    codes JAX's Pallas kernels share, through the plain products in
    ``test_spmm_family_matches_jax``): each column's tile-row codes K-major
    at the product's padding (``kmajor_plan``), zero past the rows, the
    tile and the columns, the same scales; and ``to_core_tiles``, the
    order the card's pre-pass writes, holds code [t, n, k] at [t, n // 8,
    k // 16, n % 8, k % 16]."""
    from sputnik_tpu_torch.ops.kernels import bsr_spmm_int8 as k8

    rng = np.random.RandomState(rows + cols)
    x = torch.from_numpy(rng.randn(rows, cols).astype(np.float32) * 3)
    kp, ncols = k8.kmajor_plan(tr, cols)
    assert kp % k8.KSTEP == 0 and kp - k8.KSTEP < tr <= kp
    assert ncols % k8.BLOCK_COLS == 0 and ncols - k8.BLOCK_COLS < cols
    codes, scales = k8.quant_kmajor_plain(x, tr, tc, n_tiles, kp, ncols)
    nct = -(-cols // tc)
    xp = torch.zeros(n_tiles * tr, nct * tc)
    xp[:rows, :cols] = x[:n_tiles * tr]
    q, ref_scales = k8.quant_tile(xp, tr, tc)
    want = torch.zeros((n_tiles, ncols, kp), dtype=torch.int8)
    want[:, :cols, :tr] = q.view(n_tiles, tr, -1).transpose(1, 2)[:, :cols]
    assert torch.equal(codes, want)
    assert torch.equal(scales, ref_scales)
    core, core_scales = k8.quant_kmajor(x, tr, tc, n_tiles)
    assert core.shape == (n_tiles, ncols // 8, kp // 16, 8, 16)
    t, n, k = n_tiles - 1, cols - 1, tr - 1
    assert core[t, n // 8, k // 16, n % 8, k % 16] == want[t, n, k]
    assert torch.equal(core.permute(0, 1, 3, 2, 4).reshape(codes.shape),
                       codes)
    assert torch.equal(core_scales, scales)


@pytest.mark.parametrize("d", [32, 160])
def test_sddmm_int8_matches_jax(d):
    """One 128-deep chunk, and two with a ragged second chunk."""
    a, rng = _matrix(seed=11)
    jspec, tspec, _ = _specs(a)
    lhs = rng.randn(M, d).astype(np.float32)
    rhs = rng.randn(K, d).astype(np.float32)
    with _backend("pallas"):
        jp = jq8.sddmm_int8(jspec, jnp.asarray(lhs), jnp.asarray(rhs))
        tp = tq8.sddmm_int8(tspec, torch.from_numpy(lhs),
                            torch.from_numpy(rhs))
    # compare values at the nonzeros (the panels share the 16 x 16 tiles)
    t = tspec.topo
    jv = JP.panel_to_values_np(jspec.topo, np.asarray(jp), TILE, TILE)[:t.nnz]
    tv = TP.panel_to_values_np(t, tp.numpy(), TILE, TILE)[:t.nnz]
    _close(tv, jv, 1e-5)
    assert np.all(tp.numpy()[tspec.view.mask == 0] == 0)


def _attention_specs(bm, bk, masks, heads):
    jspec = jbp.BatchedPanelSpec.from_many_mask(
        jmm.ManyMaskTopology.from_dense_masks(masks), heads=heads, bm=bm,
        bk=bk)
    tspec = BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=heads, bm=bm,
        bk=bk)
    return jspec, tspec


def _attention_problem(bm, bk, seed=11, s=64, hd=16, heads=2):
    rng = np.random.RandomState(seed)
    masks = np.stack([np.tril(np.ones((s, s), np.float32)),
                      (rng.rand(s, s) < 0.4).astype(np.float32)])
    masks[0, 9] = 0.0                          # a fully-masked row
    jspec, tspec = _attention_specs(bm, bk, masks, heads)
    R = 2 * heads
    qkv = [rng.randn(R, s, hd).astype(np.float32) for _ in range(4)]
    return jspec, tspec, qkv


@pytest.mark.parametrize("bm,bk", [(32, 32), (16, 32), (64, 64)])
def test_attention_int8_matches_jax(bm, bk):
    jspec, tspec, (q, k, v, _) = _attention_problem(bm, bk)
    with _backend("pallas"):
        jout = jq8.attention_int8(jspec, *map(jnp.asarray, (q, k, v)))
        tout = tq8.attention_int8(tspec, *map(torch.from_numpy, (q, k, v)))
    _close(tout, jout, 1e-4)
    assert torch.all(tout[:2, 9] == 0)         # the fully-masked row
    with _backend("xla"):
        ref = tq8.attention_int8(tspec, *map(torch.from_numpy, (q, k, v)))
    rel = (tout - ref).abs().max() / ref.abs().max()
    assert 1e-3 < rel < 6e-2, rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_qat_matches_jax(dtype):
    """Forward and both gradients under the int8 algebra, at f32 and bf16
    activations; gradient dtypes as JAX's (dense's and the panel's)."""
    a, rng = _matrix(seed=12)
    jspec, tspec, panel = _specs(a)
    dense = rng.randn(K, Q).astype(np.float32)
    cot = rng.randn(M, Q).astype(np.float32)
    jd = jnp.asarray(dense, getattr(jnp, dtype))
    td = torch.from_numpy(dense).to(getattr(torch, dtype)).requires_grad_()
    tp = torch.from_numpy(panel).requires_grad_()
    with _backend("pallas"):
        jout = jq8.spmm_qat(jspec, jnp.asarray(panel), jd)
        jgp, jgd = jax.grad(
            lambda p, d: jnp.sum(jq8.spmm_qat(jspec, p, d) * cot),
            argnums=(0, 1))(jnp.asarray(panel), jd)
        tout = tq8.spmm_qat(tspec, tp, td)
        (tout * torch.from_numpy(cot)).sum().backward()
    _close(tout.detach(), jout, 1e-5)
    assert td.grad.dtype == td.dtype and tp.grad.dtype == tp.dtype
    assert str(jgd.dtype) == dtype
    _close(td.grad.float(), np.asarray(jgd, np.float32), 1e-2
           if dtype == "bfloat16" else 1e-5)
    t = tspec.topo
    jv = JP.panel_to_values_np(jspec.topo, np.asarray(jgp), TILE, TILE)
    tv = TP.panel_to_values_np(t, tp.grad.numpy(), TILE, TILE)
    _close(tv[:t.nnz], jv[:t.nnz], 1e-5)


def test_attention_qat_matches_jax():
    """The forward equals attention_int8; the gradients equal the fp32
    fused chain's (JAX: atol 1e-6) and JAX's attention_qat gradients."""
    jspec, tspec, (q, k, v, cot) = _attention_problem(32, 32, seed=13)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tcot = torch.from_numpy(cot)
    with _backend("pallas"):
        out = tq8.attention_qat(tspec, tq, tk, tv)
        ref_fwd = tq8.attention_int8(tspec, tq.detach(), tk.detach(),
                                     tv.detach())
        (out * tcot).sum().backward()
        fq, fk, fv = (x.detach().clone().requires_grad_() for x in (tq, tk,
                                                                   tv))
        (fused_sparse_attention(tspec, fq, fk, fv) * tcot).sum().backward()
        jg = jax.grad(lambda a, b, c: jnp.sum(
            jq8.attention_qat(jspec, a, b, c) * cot),
            argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), ref_fwd.numpy(),
                               atol=1e-6)
    for a, b, c in zip((tq, tk, tv), (fq, fk, fv), jg):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-6)
        _close(a.grad, c, 1e-4)


@pytest.mark.parametrize("route", ["auto", "xla"])
def test_fp32_routes_match_jax(route):
    """JAX's off-TPU route on CPU tensors: the fp32 oracle on the
    dequantised panel, fp32 SDDMM and fused attention."""
    a, rng = _matrix(seed=14)
    jspec, tspec, panel = _specs(a)
    jqp = jq8.quantize_panel(jspec, panel)
    tqp = tq8.quantize_panel(tspec, panel)
    dense = rng.randn(K, Q).astype(np.float32)
    g = rng.randn(M, Q).astype(np.float32)
    lhs, rhs = rng.randn(M, 24).astype(np.float32), rng.randn(
        K, 24).astype(np.float32)
    ajspec, atspec, (q, k, v, _) = _attention_problem(32, 32, seed=15)
    with _backend(route):
        pairs = [
            (jq8.spmm_int8(jspec, jqp, jnp.asarray(dense)),
             tq8.spmm_int8(tspec, tqp, torch.from_numpy(dense))),
            (jq8.spmm_t_int8(jspec, jqp, jnp.asarray(g)),
             tq8.spmm_t_int8(tspec, tqp, torch.from_numpy(g))),
            (jq8.attention_int8(ajspec, *map(jnp.asarray, (q, k, v))),
             tq8.attention_int8(atspec, *map(torch.from_numpy, (q, k, v))))]
        jsd = jq8.sddmm_int8(jspec, jnp.asarray(lhs), jnp.asarray(rhs))
        tsd = tq8.sddmm_int8(tspec, torch.from_numpy(lhs),
                             torch.from_numpy(rhs))
    for j, t in pairs:
        _close(t, j, 1e-5)
    nnz = tspec.topo.nnz
    _close(TP.panel_to_values_np(tspec.topo, tsd.numpy(), TILE, TILE)[:nnz],
           JP.panel_to_values_np(jspec.topo, np.asarray(jsd), TILE,
                                 TILE)[:nnz], 1e-5)
    # the fp32 route is the dequantised product
    deq = (tqp.values_q.float() * tqp.scales[:, :, None, None]).numpy()
    dq_dense = TP.panel_to_values_np(tspec.topo, deq, TILE, TILE)
    ref = np.zeros((M, K), np.float32)
    t = tspec.topo
    ref[t.row_ids[:nnz], t.column_indices[:nnz]] = dq_dense[:nnz]
    _close(pairs[0][1], ref @ dense, 1e-5)


def test_attention_qat_backward_argument():
    """``backward="int8"`` runs (it raised before its kernels were ported);
    any other name but "fp32" raises."""
    _, tspec, (q, k, v, _) = _attention_problem(32, 32)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    with _backend("pallas"):
        out = tq8.attention_qat(tspec, *args, backward="int8")
    assert out.shape == args[0].shape and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="backward"):
        tq8.attention_qat(tspec, *args, backward="int4")


def _qat_grads(jspec, tspec, q, k, v, cot, dtype="float32"):
    """Port and JAX ``attention_qat(backward="int8")`` gradients at ``dtype``
    primals under the current routes: (port out, port grads, JAX grads)."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    out = tq8.attention_qat(tspec, tq, tk, tv, backward="int8")
    (out.float() * torch.from_numpy(cot)).sum().backward()
    jg = jax.grad(lambda a, b, c: jnp.sum(jq8.attention_qat(
        jspec, a, b, c, backward="int8").astype(jnp.float32) * cot),
        argnums=(0, 1, 2))(*(jnp.asarray(x, jdt) for x in (q, k, v)))
    return out, (tq.grad, tk.grad, tv.grad), jg


@pytest.mark.parametrize("bm,bk", [(32, 32), (16, 32), (64, 64)])
def test_attention_qat_int8_backward_matches_jax(bm, bk):
    """The full-int8 training path under ``set_backend("pallas")``: the
    port's plain B18a / B18b / B18c against JAX's Pallas kernels in
    interpret mode on the same grid. The forward is attention_int8's; the
    gradients JAX's within 1e-3 x max|ref| (the same integer products and
    codes; f32 sums, D = rowsum(g * out) and exp in another order or
    implementation), and within JAX's own 8e-2 of the fp32 fused chain
    (the W8A8 class); the fully-masked row's dq is exactly 0."""
    jspec, tspec, (q, k, v, cot) = _attention_problem(bm, bk, seed=13)
    with _backend("pallas"):
        out, grads, jg = _qat_grads(jspec, tspec, q, k, v, cot)
        ref_fwd = tq8.attention_int8(tspec, *map(torch.from_numpy,
                                                 (q, k, v)))
        fq, fk, fv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        (fused_sparse_attention(tspec, fq, fk, fv)
         * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref_fwd.numpy(),
                               atol=1e-6)
    for name, got, j, f in zip("qkv", grads, jg, (fq, fk, fv)):
        assert got.dtype == torch.float32
        _close(got, np.asarray(j), 1e-3)
        rel = (got - f.grad).abs().max() / f.grad.abs().max()
        assert 1e-3 < rel < 8e-2, (name, rel)
    assert torch.all(grads[0][:2, 9] == 0)     # the fully-masked row


def test_flash_int8_backward_plain_matches_jax_kernels():
    """The plain B18b / B18c against JAX's ``flash_sparse_bwd_dq_int8`` /
    ``flash_sparse_bwd_dkv_int8`` in interpret mode, called directly on the
    same padded operands (rows to the mask's, head dims to 128 lanes; the
    stats and D packed into JAX's 128-lane layout)."""
    from sputnik_tpu.ops.pallas import flash_sparse_int8 as jfs8
    from sputnik_tpu_torch.ops.kernels import flash_sparse_int8 as tfs8

    jspec, tspec, (q, k, v, g) = _attention_problem(32, 32, seed=16)
    fm, bmeta = tspec.flash_meta("cpu"), tspec.flash_bwd_meta("cpu")
    R, s, hd = q.shape
    m_pad, scale = tspec.mb * 32, hd ** -0.5

    def pad(x):
        return np.pad(x, ((0, 0), (0, m_pad - x.shape[1]), (0, 128 - hd)))

    qp, kp, vp, gp = map(pad, (q, k, v, g))
    fwd = (fm["block_cols"], fm["nblocks"], fm["mask_slot"],
           fm["is_partial"], fm["pmask"])
    out, stats = jfs8.flash_sparse_attention_fwd_int8(
        *(np.asarray(x) for x in fwd), qp * np.float32(scale), kp, vp, R=R,
        heads=2, mb=tspec.mb, max_bpr=fm["max_bpr"], bm=32, bk=32,
        interpret=True)
    out, stats = np.asarray(out), np.asarray(stats)
    D = (gp * out).sum(-1)
    dcoef = np.broadcast_to(D[:, :, None], (R, m_pad, 128))
    common = dict(R=R, heads=2, bm=32, bk=32, interpret=True)
    jops = (qp * np.float32(scale), kp, vp, gp, stats, dcoef)
    jdq = jfs8.flash_sparse_bwd_dq_int8(
        *(np.asarray(x) for x in fwd), *jops, mb=tspec.mb,
        max_bpr=fm["max_bpr"], **common)
    tcols = (bmeta["t_src_i"], bmeta["t_nblocks"], bmeta["t_mask_slot"],
             bmeta["t_is_partial"], bmeta["pmask"])
    jdk, jdv = jfs8.flash_sparse_bwd_dkv_int8(
        *(np.asarray(x) for x in tcols), *jops, kb=tspec.kb,
        max_bpc=bmeta["max_bpc"], **common)
    tops = (*map(torch.from_numpy, (qp, kp, vp, gp)),
            torch.from_numpy(stats[:, :, 0].copy()),
            torch.from_numpy(stats[:, :, 1].copy()), torch.from_numpy(D))
    kw = dict(heads=2, scale=scale)
    tdq = tfs8.flash_sparse_bwd_dq_int8(*fwd, *tops, max_bpr=fm["max_bpr"],
                                        **kw)
    tdk, tdv = tfs8.flash_sparse_bwd_dkv_int8(*tcols, *tops,
                                              max_bpc=bmeta["max_bpc"], **kw)
    _close(tdq, np.asarray(jdq), 1e-5)
    _close(tdk, np.asarray(jdk), 1e-5)
    _close(tdv, np.asarray(jdv), 1e-5)
    assert torch.all(tdq[:2, 9] == 0)          # the fully-masked row


def test_attention_qat_int8_backward_bf16_primals():
    """JAX's bf16 case (``test_pallas.py``'s int8-backward attention): bf16
    q / k / v give bf16 gradients, here also equal in value to JAX's. hd =
    32, so the scale 1/sqrt(32) must be rounded to bf16 before ``q *
    scale``, as JAX rounds a Python scalar to the array's dtype: the f32
    forward then equals JAX's at attention_int8's 1e-4 x max|ref| (an
    unrounded scale moves q codes: 5e-4). Gradients at 1e-2 x max|ref|:
    they are rounded once from f32 to bf16, so one rounding step (2^-8
    relative) may part them."""
    masks = np.tril(np.ones((1, 32, 32), np.float32))
    jspec, tspec = _attention_specs(16, 16, masks, heads=1)
    rng = np.random.RandomState(18)
    q = rng.randn(1, 32, 32).astype(np.float32)
    cot = rng.randn(1, 32, 32).astype(np.float32)
    qkv = (q, q + 1, q - 1)
    with _backend("pallas"):
        out, grads, jg = _qat_grads(jspec, tspec, *qkv, cot,
                                    dtype="bfloat16")
        jout = jq8.attention_int8(jspec, *(jnp.asarray(x, jnp.bfloat16)
                                           for x in qkv))
    assert out.dtype == torch.float32
    _close(out.detach(), jout, 1e-4)
    for got, j in zip(grads, jg):
        assert got.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        _close(got.float(), np.asarray(j, np.float32), 1e-2)


@pytest.mark.parametrize("route", ["auto", "xla"])
def test_attention_qat_int8_backward_fp32_routes(route):
    """On CPU tensors under "auto", and under "xla", ``backward="int8"`` is
    the fp32 fused attention both ways, as JAX's off-TPU route."""
    jspec, tspec, (q, k, v, cot) = _attention_problem(32, 32, seed=19)
    with _backend(route):
        out, grads, jg = _qat_grads(jspec, tspec, q, k, v, cot)
        fq, fk, fv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        ref = fused_sparse_attention(tspec, fq, fk, fv)
        (ref * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ref.detach().numpy())
    for got, j, f in zip(grads, jg, (fq, fk, fv)):
        assert torch.equal(got, f.grad)
        _close(got, np.asarray(j), 1e-5)


def test_serve_sparse_int8_example_small_cpu():
    from sputnik_tpu_torch.examples import serve_sparse_int8

    res = serve_sparse_int8.main(["--small", "--device", "cpu"])
    assert 0 < res["rel_err"] < 0.1
    assert stt.get_backend() == "auto"


@pytest.mark.parametrize("s_kv,hd", [(200, 16), (128, 100)])
def test_flash_int8_prepass_codes_match_jax_quant_tile(s_kv, hd):
    """B18a's pre-pass (its plain twin ``quant_kv_plain``) quantises each
    64-key block of k and v once a call: codes and scales equal to JAX's
    ``_quant_tile`` of that block (the TPU kernel's per-visit
    quantisation), zero past the keys and the head dims; V's transposed
    codes round-trip, and ``to_core_tiles`` holds code [t, d, key] at [t,
    d // 8, key // 16, d % 8, key % 16], the order the card writes."""
    from sputnik_tpu.ops.pallas.bsr_spmm_int8 import _quant_tile
    from sputnik_tpu_torch.ops.kernels import flash_sparse_int8 as tfs8
    from sputnik_tpu_torch.ops.kernels.bsr_spmm_int8 import to_core_tiles

    rng = np.random.RandomState(s_kv + hd)
    k, v = (rng.randn(2, s_kv, hd).astype(np.float32) * 3 for _ in range(2))
    hdp = 64 if hd <= 64 else 128
    kq, vt, scales = tfs8.quant_kv_plain(torch.from_numpy(k),
                                         torch.from_numpy(v), hdp)
    kb = -(-s_kv // 64)
    assert kq.shape == (2, kb, 64, hdp) and vt.shape == (2, kb, hdp, 64)
    assert kq.dtype == vt.dtype == torch.int8
    vq = vt.transpose(-1, -2)
    for r in range(2):
        for c in range(kb):
            for j, (x, codes) in enumerate(((k, kq), (v, vq))):
                blk = np.zeros((64, hd), np.float32)
                rows = x[r, c * 64:(c + 1) * 64]
                blk[:rows.shape[0]] = rows
                jq, js = _quant_tile(jnp.asarray(blk))
                np.testing.assert_array_equal(codes[r, c, :, :hd].numpy(),
                                              np.asarray(jq))
                assert not codes[r, c, :, hd:].any()
                assert scales[r, c, j].item() == np.float32(js)
    flat = vt.reshape(2 * kb, hdp, 64)
    core = to_core_tiles(flat)
    t, d, key = 2 * kb - 1, hd - 1, 37
    assert core[t, d // 8, key // 16, d % 8, key % 16] == flat[t, d, key]
    assert torch.equal(core.permute(0, 1, 3, 2, 4).reshape(flat.shape),
                       flat)
    assert torch.equal(vt.transpose(-1, -2).transpose(-1, -2), vt)


@pytest.mark.parametrize("s_q,hd", [(200, 16), (128, 100)])
def test_flash_int8_row_prepass_codes_match_jax_quant_tile(s_q, hd):
    """B18c's pre-pass (its plain twin ``quant_rows_plain``) quantises each
    64-row block of ``q * scale`` and of ``g`` once a call: codes and scales
    equal to JAX's ``_quant_tile`` of that block (the TPU kernel's per-visit
    quantisation), zero past the rows and the head dims; the transposed
    copy (the gradient products' operand, K-major along the rows) holds
    the same codes, and ``to_core_tiles`` gives it the order the card
    writes."""
    from sputnik_tpu.ops.pallas.bsr_spmm_int8 import _quant_tile
    from sputnik_tpu_torch.ops.kernels import flash_sparse_int8 as tfs8
    from sputnik_tpu_torch.ops.kernels.bsr_spmm_int8 import to_core_tiles

    rng = np.random.RandomState(s_q + hd)
    q, g = (rng.randn(2, s_q, hd).astype(np.float32) * 3 for _ in range(2))
    scale = hd ** -0.5
    hdp = 64 if hd <= 64 else 128
    mb = -(-s_q // 64)
    qq, gq, qt, gt, scales = tfs8.quant_rows_plain(
        torch.from_numpy(q), torch.from_numpy(g), scale, mb, hdp)
    assert qq.shape == gq.shape == (2, mb, 64, hdp)
    assert qt.shape == gt.shape == (2, mb, hdp, 64)
    assert qq.dtype == qt.dtype == torch.int8
    assert torch.equal(qt, qq.transpose(-1, -2))
    assert torch.equal(gt, gq.transpose(-1, -2))
    for r in range(2):
        for i in range(mb):
            for j, (x, mul, codes) in enumerate(((q, scale, qq),
                                                 (g, 1.0, gq))):
                blk = np.zeros((64, hd), np.float32)
                rows = (torch.from_numpy(x[r, i * 64:(i + 1) * 64])
                        * mul).numpy()
                blk[:rows.shape[0]] = rows
                jq, js = _quant_tile(jnp.asarray(blk))
                np.testing.assert_array_equal(codes[r, i, :, :hd].numpy(),
                                              np.asarray(jq))
                assert not codes[r, i, :, hd:].any()
                assert scales[r, i, j].item() == np.float32(js)
    flat = qt.reshape(2 * mb, hdp, 64)
    core = to_core_tiles(flat)
    t, d, row = 2 * mb - 1, hd - 1, 37
    assert core[t, d // 8, row // 16, d % 8, row % 16] == flat[t, d, row]
    assert tfs8.row_record_bytes(hd) % 128 == 0
    assert tfs8.row_record_bytes(hd) >= 4 * 64 * hdp + (3 * 64 + 2) * 4


@pytest.mark.parametrize("s_kv,hd", [(130, 32), (130, 100), (130, 128),
                                     (2048, 32), (2048, 100), (2048, 128)])
def test_flash_int8_key_prepass_codes_match_jax_quant_tile(s_kv, hd):
    """B18b's pre-pass (its plain twin ``quant_keys_plain``) quantises each
    64-key block of k and v once a call: K's and V's codes K-major along
    the head dim and K's transposed (K-major along the keys), and the
    scales, equal to JAX's ``_quant_tile`` of that block (the TPU kernel's
    per-visit quantisation), zero past the keys and the head dims;
    ``to_core_tiles`` gives the transposed codes the order the card
    writes, and the record holds them all."""
    from sputnik_tpu.ops.pallas.bsr_spmm_int8 import _quant_tile
    from sputnik_tpu_torch.ops.kernels import flash_sparse_int8 as tfs8
    from sputnik_tpu_torch.ops.kernels.bsr_spmm_int8 import to_core_tiles

    rng = np.random.RandomState(s_kv + hd)
    k, v = (rng.randn(2, s_kv, hd).astype(np.float32) * 3 for _ in range(2))
    hdp = 64 if hd <= 64 else 128
    kb = -(-s_kv // 64)
    kq, vq, kt, scales = tfs8.quant_keys_plain(torch.from_numpy(k),
                                               torch.from_numpy(v), hdp)
    assert kq.shape == vq.shape == (2, kb, 64, hdp)
    assert kt.shape == (2, kb, hdp, 64) and scales.shape == (2, kb, 2)
    assert kq.dtype == vq.dtype == kt.dtype == torch.int8
    assert torch.equal(kt, kq.transpose(-1, -2))
    quant = jax.vmap(_quant_tile)
    for j, (x, codes) in enumerate(((k, kq), (v, vq))):
        blocks = np.zeros((2, kb * 64, hd), np.float32)
        blocks[:, :s_kv] = x
        jq, js = quant(jnp.asarray(blocks.reshape(2 * kb, 64, hd)))
        np.testing.assert_array_equal(
            codes[..., :hd].reshape(2 * kb, 64, hd).numpy(), np.asarray(jq))
        assert not codes[..., hd:].any()
        np.testing.assert_array_equal(scales[..., j].reshape(-1).numpy(),
                                      np.asarray(js))
    flat = kt.reshape(2 * kb, hdp, 64)
    core = to_core_tiles(flat)
    t, d, key = 2 * kb - 1, hd - 1, 37
    assert core[t, d // 8, key // 16, d % 8, key % 16] == flat[t, d, key]
    assert tfs8.key_record_bytes(hd) % 128 == 0
    assert tfs8.key_record_bytes(hd) >= 3 * 64 * hdp + 2 * 4


@pytest.mark.parametrize("d,bm", [(20, 48), (64, 48), (300, 48), (20, 128),
                                  (64, 128), (300, 128)])
def test_sddmm_int8_prepass_codes_match_jax_quant_tile(d, bm):
    """B17's pre-pass (its plain twin ``sddmm_quant_plain``) quantises each
    [bm, 128] tile of an operand once: every row of the tile on one scale a
    128-deep chunk, also where the tile spans two 64-row slices (bm = 128)
    or ends inside one (bm = 48); codes and scales equal to JAX's
    ``_quant_tile`` of the zero-padded tile (the TPU kernel's), zero past
    the tile's rows and past the depth; ``to_core_tiles`` of the [64, 128]
    slices is the order the card writes."""
    from sputnik_tpu.ops.pallas.bsr_spmm_int8 import _quant_tile
    from sputnik_tpu_torch.ops.kernels import bsr_spmm_int8 as k8

    rows = 3 * bm - 7
    rng = np.random.RandomState(d + bm)
    x = rng.randn(rows, d).astype(np.float32) * 3
    n_tiles, dt, nsl = 3, -(-d // 128), -(-bm // 64)
    codes, scales = k8.sddmm_quant_plain(torch.from_numpy(x), bm, n_tiles)
    assert codes.shape == (n_tiles, dt, nsl * 64, 128)
    assert scales.shape == (n_tiles, dt) and codes.dtype == torch.int8
    xp = np.zeros((n_tiles * bm, dt * 128), np.float32)
    xp[:rows, :d] = x
    tiles = xp.reshape(n_tiles, bm, dt, 128).transpose(0, 2, 1, 3)
    jq, js = jax.vmap(_quant_tile)(jnp.asarray(tiles.reshape(-1, bm, 128)))
    np.testing.assert_array_equal(
        codes[:, :, :bm].reshape(-1, bm, 128).numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scales.reshape(-1).numpy(), np.asarray(js))
    assert not codes[:, :, bm:].any()
    assert not codes[:, -1, :, d - (dt - 1) * 128:].any()
    flat = codes.view(-1, 64, 128)
    core = k8.to_core_tiles(flat)
    t, row, k = flat.shape[0] - 1, 40, d % 128 - 1
    assert core[t, row // 8, k // 16, row % 8, k % 16] == flat[t, row, k]


def test_flash_int8_split_walk_is_another_function():
    """Why B18a walks each row block serially: p's codes are rint(exp(sc -
    m) * 127) with m the running max over the tiles walked so far. On a
    seeded causal problem, the plain walk cut into two chunks (each from m
    = -1e30) and merged by the flash merge forms other p codes than the
    serial walk on the second chunk's first tile, and its output lies at
    least 10x farther from JAX's kernel (interpret mode) than the serial
    walk's does."""
    from sputnik_tpu.ops.pallas import flash_sparse_int8 as jfs8
    from sputnik_tpu_torch.ops.kernels import flash_sparse_int8 as tfs8

    s, hd, heads, bm = 256, 16, 2, 32
    masks = np.tril(np.ones((1, s, s), np.float32))
    jspec, tspec = _attention_specs(bm, bm, masks, heads)
    fm = tspec.flash_meta("cpu")
    mb, max_bpr, R = tspec.mb, fm["max_bpr"], heads
    rng = np.random.RandomState(17)
    q, k, v = (rng.randn(R, s, hd).astype(np.float32) for _ in range(3))
    scale = hd ** -0.5
    meta = (fm["block_cols"], fm["nblocks"], fm["mask_slot"],
            fm["is_partial"], fm["pmask"])
    jout, _ = jfs8.flash_sparse_attention_fwd_int8(
        *(np.asarray(x) for x in meta),
        np.pad(q, ((0, 0), (0, 0), (0, 128 - hd))) * np.float32(scale),
        *(np.pad(x, ((0, 0), (0, 0), (0, 128 - hd))) for x in (k, v)),
        R=R, heads=heads, mb=mb, max_bpr=max_bpr, bm=bm, bk=bm,
        interpret=True)
    jout = np.asarray(jout)[..., :hd]
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kw = dict(heads=heads, scale=scale)
    serial, _, _ = tfs8.flash_sparse_attention_fwd_int8_plain(
        *meta, tq, tk, tv, max_bpr=max_bpr, **kw)

    # the walk cut at slot n1: chunk A = slots [0, n1), chunk B = the rest
    n1 = max_bpr // 2
    nb = fm["nblocks"]

    def shifted(x):
        x = x.view(1, mb, max_bpr)
        return torch.cat([x[..., n1:], torch.zeros_like(x[..., :n1])],
                         -1).reshape(1, -1).contiguous()

    out_a, m_a, l_a = tfs8.flash_sparse_attention_fwd_int8_plain(
        *meta[:1], nb.clamp(max=n1), *meta[2:], tq, tk, tv,
        max_bpr=max_bpr, **kw)
    out_b, m_b, l_b = tfs8.flash_sparse_attention_fwd_int8_plain(
        shifted(fm["block_cols"]), (nb - n1).clamp(min=0),
        shifted(fm["mask_slot"]), shifted(fm["is_partial"]), fm["pmask"],
        tq, tk, tv, max_bpr=max_bpr, **kw)
    big = torch.maximum(m_a, m_b)
    w_a, w_b = l_a * torch.exp(m_a - big), l_b * torch.exp(m_b - big)
    merged = ((out_a * w_a[:, :s, None] + out_b * w_b[:, :s, None])
              / (w_a + w_b).clamp(min=1e-30)[:, :s, None])

    # p's codes on chunk B's first tile of the last row block: the serial
    # walk's running max there is chunk A's m
    i, c = mb - 1, int(fm["block_cols"].view(mb, max_bpr)[mb - 1, n1])
    q_q, q_s = tfs8._quant_blocks(tq * scale, mb, bm)
    k_q, k_s = tfs8._quant_blocks(tk, mb, bm)
    sc = (q_q[:, i] @ k_q[:, c].transpose(-1, -2)).float() * (
        q_s[:, i] * k_s[:, c])[:, None, None]
    m_serial = torch.maximum(m_a.view(R, mb, bm)[:, i], sc.amax(-1))
    codes = [torch.round(torch.exp(sc - mm[..., None]) * 127.0)
             for mm in (m_serial, sc.amax(-1))]
    assert not torch.equal(codes[0], codes[1])

    d_serial = np.abs(serial.numpy() - jout).max()
    d_merged = np.abs(merged.numpy() - jout).max()
    assert d_serial <= 1e-4 * np.abs(jout).max(), d_serial
    assert d_merged >= 10 * max(d_serial, 1e-6 * np.abs(jout).max()), (
        d_merged, d_serial)
