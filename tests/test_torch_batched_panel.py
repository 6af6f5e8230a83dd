"""The port's batched panel ops (``ops/batched_panel.py``: ``spmm_bh``,
``sddmm_bh``, ``sparse_softmax_bh``) and the differentiable many-mask ops
(``many_mask.py``) against the JAX package on the CPU.

The port runs its kernels' plain versions; the JAX package runs its
batched ops under ``set_backend("xla")`` (the many-mask oracle) and
``set_backend("pallas")`` (the Pallas kernels in interpret mode). Three
DISTINCT masks (``tril(k=-i)``, one with a fully-masked row), so a replica
reading its neighbour's metadata would show. The packages tile differently
(JAX 16 x 16 here, the port 16 x 16 and 32 x 32), so panels are compared as
flat CSR values, never as panel bytes. Tolerances: forward 1e-4, gradients
1e-3 (f32, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sputnik_tpu as st
from sputnik_tpu import many_mask as jmm
from sputnik_tpu.ops import batched_panel as jbp
import sputnik_tpu_torch as stt
from sputnik_tpu_torch.ops import batched_panel as tbp

FWD = dict(atol=1e-4, rtol=1e-4)
GRAD = dict(atol=1e-3, rtol=1e-3)
B, S, HD = 3, 40, 8
SCALE = 1.0 / float(np.sqrt(HD))   # a python float keeps JAX in f32


def _masks():
    masks = np.stack([np.tril(np.ones((S, S), np.float32), k=-i)
                      for i in range(B)])
    masks[0, 7] = 0.0                   # a fully-masked row
    return masks


def _jax_chain(backend, heads, q, k, v, cot):
    """JAX's batched chain and its VJP under ``backend``."""
    jmt = jmm.ManyMaskTopology.from_dense_masks(_masks())
    st.set_backend(backend)
    try:
        spec = jbp.BatchedPanelSpec.from_many_mask(jmt, heads=heads, bm=16,
                                                   bk=16)

        def chain(q_, k_, v_):
            sc = jbp.sddmm_bh(spec, q_, k_) * SCALE
            return jbp.spmm_bh(spec, jbp.sparse_softmax_bh(spec, sc), v_)

        q, k, v = (jnp.asarray(x, jnp.float32) for x in (q, k, v))
        out, vjp = jax.vjp(chain, q, k, v)
        grads = vjp(jnp.asarray(cot, jnp.float32))
        scores = jbp.sddmm_bh(spec, q, k)
        flat = np.asarray(spec.unstack_values(scores, jmt.nnz_pad))
    finally:
        st.set_backend("auto")
    return np.asarray(out), [np.asarray(g) for g in grads], flat


def _inputs(heads, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B * heads, S, HD).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("tiles", [16, 32])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_panel_chain_and_grads_match_jax(backend, heads, tiles):
    q, k, v, cot = _inputs(heads)
    ref, ref_grads, ref_scores = _jax_chain(backend, heads, q, k, v, cot)
    mt = stt.ManyMaskTopology.from_dense_masks(_masks())
    spec = tbp.BatchedPanelSpec.from_many_mask(mt, heads=heads, bm=tiles,
                                               bk=tiles)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    scores = tbp.sddmm_bh(spec, tq, tk)
    w = tbp.sparse_softmax_bh(spec, scores * SCALE)
    out = tbp.spmm_bh(spec, w, tv)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), ref, **FWD)
    np.testing.assert_allclose(
        spec.unstack_values(scores.detach(), mt.nnz_pad).numpy(), ref_scores,
        **FWD)
    for name, t, g in zip("qkv", (tq, tk, tv), ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), g, **GRAD, err_msg=name)
    # the fully-masked row of mask 0: zeros through the chain, no NaN
    assert torch.all(out[:heads, 7] == 0) and torch.isfinite(out).all()


@pytest.mark.parametrize("heads", [1, 2])
def test_spmm_bh_values_gradient_matches_jax(heads):
    """``spmm_bh`` on trained values: d_panels (B7 in the backward) and
    d_dense (B8) against JAX's ``jax.vjp``, values compared flat."""
    rng = np.random.RandomState(1)
    jmt = jmm.ManyMaskTopology.from_dense_masks(_masks())
    mt = stt.ManyMaskTopology.from_dense_masks(_masks())
    vals = rng.randn(B * heads, mt.nnz_pad).astype(np.float32)
    dense = rng.randn(B * heads, S, 5).astype(np.float32)
    cot = rng.randn(B * heads, S, 5).astype(np.float32)
    jspec = jbp.BatchedPanelSpec.from_many_mask(jmt, heads=heads, bm=16,
                                                bk=16)
    out, vjp = jax.vjp(lambda p, d: jbp.spmm_bh(jspec, p, d),
                       jnp.asarray(jspec.stack_values(vals)),
                       jnp.asarray(dense, jnp.float32))
    g_p, g_d = vjp(jnp.asarray(cot, jnp.float32))
    spec = tbp.BatchedPanelSpec.from_many_mask(mt, heads=heads, bm=32, bk=16)
    panels = torch.from_numpy(spec.stack_values(vals)).requires_grad_()
    td = torch.from_numpy(dense).requires_grad_()
    got = tbp.spmm_bh(spec, panels, td)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **FWD)
    np.testing.assert_allclose(
        spec.unstack_values(panels.grad, mt.nnz_pad).numpy(),
        np.asarray(jspec.unstack_values(g_p, jmt.nnz_pad)), **GRAD)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(g_d), **GRAD)
    # the panel gradient is exactly 0 at masked and padded slots
    off = ~spec.mask_bh("cpu").expand(B, heads, *spec.panel_shape)
    assert torch.all(panels.grad.view(off.shape)[off] == 0)


def test_unstack_values_round_trip():
    heads = 2
    mt = stt.ManyMaskTopology.from_dense_masks(_masks())
    spec = tbp.BatchedPanelSpec.from_many_mask(mt, heads=heads, bm=16,
                                               bk=32)
    vals = np.random.RandomState(4).randn(spec.R, mt.nnz_pad).astype(
        np.float32)
    back = spec.unstack_values(torch.from_numpy(spec.stack_values(vals)),
                               mt.nnz_pad).numpy()
    for r in range(spec.R):
        nnz = mt.nnzs[r // heads]
        np.testing.assert_array_equal(back[r, :nnz], vals[r, :nnz])
        assert np.all(back[r, nnz:] == 0)


def test_sddmm_bh_backward_ignores_cotangent_at_masked_slots():
    """The sampled product is 0 at masked and padded slots whatever its
    inputs, so a cotangent there carries no gradient."""
    heads = 2
    mt = stt.ManyMaskTopology.from_dense_masks(_masks())
    spec = tbp.BatchedPanelSpec.from_many_mask(mt, heads=heads, bm=16,
                                               bk=16)
    q, k, _, _ = _inputs(heads, seed=2)
    cot = torch.from_numpy(np.random.RandomState(3).randn(
        spec.R, *spec.panel_shape).astype(np.float32))
    keep = spec.mask_bh("cpu").expand(B, heads, *spec.panel_shape).reshape(
        cot.shape)
    grads = []
    for c in (cot, torch.where(keep, cot, 0.0)):
        tq, tk = (torch.from_numpy(x).requires_grad_() for x in (q, k))
        tbp.sddmm_bh(spec, tq, tk).backward(c)
        grads.append((tq.grad, tk.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_batched_ops_gradcheck_in_float64():
    """The autograd algebra against finite differences (plain versions,
    float64), on two distinct masks with two heads."""
    masks = _masks()[:2, :20, :20]
    spec = tbp.BatchedPanelSpec(
        [stt.SparseTopology.from_dense_mask(m) for m in masks], heads=2,
        bm=8, bk=8)
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(4, 20, 3)).requires_grad_()
               for _ in range(3))

    def chain(q_, k_, v_):
        w = tbp.sparse_softmax_bh(spec, tbp.sddmm_bh(spec, q_, k_))
        return tbp.spmm_bh(spec, w, v_)

    assert torch.autograd.gradcheck(chain, (q, k, v), eps=1e-6, atol=1e-5)


def test_batched_ops_reject_wrong_shapes():
    mt = stt.ManyMaskTopology.from_dense_masks(_masks())
    spec = tbp.BatchedPanelSpec.from_many_mask(mt, heads=2, bm=16, bk=16)
    x = torch.zeros(spec.R, S, 4)
    with pytest.raises(ValueError, match="replicas|R="):
        tbp.sddmm_bh(spec, x[:3], x[:3])
    with pytest.raises(ValueError, match="rows"):
        tbp.sddmm_bh(spec, x[:, :30], x)
    with pytest.raises(ValueError, match="panels"):
        tbp.spmm_bh(spec, torch.zeros(spec.R, 1, 1, 16, 16), x)


@pytest.mark.parametrize("heads", [1, 2])
def test_many_mask_ops_train_like_jax(heads):
    """The csr path (flat many-mask ops, plain PyTorch autograd Functions)
    against JAX's custom_vjp many-mask ops."""
    q, k, v, cot = _inputs(heads, seed=6)
    jmt = jmm.ManyMaskTopology.from_dense_masks(_masks())

    def jchain(q_, k_, v_):
        w = jmm.sparse_softmax_many_mask(
            jmt, jmm.sddmm_many_mask(jmt, q_, k_) * SCALE)
        return jmm.spmm_many_mask(jmt, w, v_)

    ref, vjp = jax.vjp(jchain, *(jnp.asarray(x, jnp.float32)
                                 for x in (q, k, v)))
    ref_grads = vjp(jnp.asarray(cot, jnp.float32))
    mt = stt.ManyMaskTopology.from_dense_masks(_masks())
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    w = stt.sparse_softmax_many_mask(
        mt, stt.sddmm_many_mask(mt, tq, tk) * SCALE)
    out = stt.spmm_many_mask(mt, w, tv)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD)
    for name, t, g in zip("qkv", (tq, tk, tv), ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD,
                                   err_msg=name)
