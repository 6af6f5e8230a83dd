"""B5's four (policy, mode) pairs on the CPU: the sparse softmax forward and
backward on CSR rows (the flat API) and on panel rows (``panel_api`` on an
ELL spec, ``batched_panel.sparse_softmax_bh``) against ``jax.vjp`` of the
JAX package's ops on the same seeded numpy inputs, and the wrappers'
plain route on CPU tensors.

The inputs hold an emptied row, a row of ``-inf`` scores, absent tiles
(causal masks) and a NaN score at a masked slot (a CSR padding slot on the
flat layout); the panel cases also run a cotangent with a NaN at a masked
slot, which reaches its row in both packages. Both packages take the same
tiles, so the panels have the same layout.

Tolerance: 1e-5 x max(1, max|ref|), f32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu import many_mask as jmm
from sputnik_tpu.ops import api as JA
from sputnik_tpu.ops import batched_panel as JB
from sputnik_tpu.ops import panel_api as JP
from sputnik_tpu.topology import SparseTopology as JTopology
from sputnik_tpu_torch import many_mask as tmm
from sputnik_tpu_torch.ops import panel_api as P
from sputnik_tpu_torch.ops.kernels import ell_softmax as K
from sputnik_tpu_torch.ops.kernels import kernel_wrappers


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    lim = 1e-5 * max(1.0, float(np.nanmax(np.abs(ref))))
    np.testing.assert_allclose(got, ref, rtol=0, atol=lim, equal_nan=True)


def _vjp_both(jfn, tfn, x, g):
    """(JAX's output, its VJP at ``g``) and the port's, from numpy."""
    out, vjp = jax.vjp(jfn, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    tout = tfn(xt)
    tout.backward(torch.from_numpy(g))
    return (np.asarray(out), np.asarray(jdx)), (tout, xt.grad)


@pytest.fixture
def xla():
    st.set_backend("xla")
    try:
        yield
    finally:
        st.set_backend("auto")


@pytest.mark.parametrize("r", [1, 3])
def test_csr_softmax_modes_match_jax(xla, r):
    """``stt.sparse_softmax`` forward and backward on CSR rows vs
    ``jax.vjp`` of ``sputnik_tpu.ops.api.sparse_softmax`` (XLA)."""
    rng = np.random.RandomState(11 + r)
    mask = rng.rand(30, 50) < 0.3
    mask[4] = False                                   # an emptied row
    mask[9] = True
    t = stt.SparseTopology.from_dense_mask(mask, pad_to=8)
    jt = JTopology.from_dense_mask(mask, pad_to=8)
    assert t.nnz_pad > t.nnz
    x = (rng.randn(r, t.nnz_pad) * 3).astype(np.float32)
    ro = t.row_offsets
    x[:, ro[9]:ro[10]] = -np.inf                      # a row of -inf scores
    x[:, t.nnz] = np.nan                              # NaN at a padding slot
    g = rng.randn(r, t.nnz_pad).astype(np.float32)
    shape = (t.nnz_pad,) if r == 1 else (r, t.nnz_pad)
    x, g = x.reshape(shape), g.reshape(shape)
    (jp, jdx), (tp, tdx) = _vjp_both(
        lambda v: JA.sparse_softmax(jt, v),
        lambda v: stt.sparse_softmax(t, v), x, g)
    _close(tp, jp)
    _close(tdx, jdx)
    assert np.isfinite(jdx).all() and torch.isfinite(tdx).all()
    assert torch.all(tp.detach()[..., t.nnz:] == 0)
    assert torch.all(tp.detach()[..., ro[9]:ro[10]] == 0)


def _causal_problem(rng, n, density):
    mask = np.tril(np.ones((n, n))) * (rng.rand(n, n) < density)
    mask[6] = 0.0                                     # an emptied row
    return mask.astype(np.float32)


def _panel_inputs(rng, shape, live, nan_cot):
    """Scores ``[.., mb, max_bpr, bm, bk]``: row 2 of row block 0 -inf, a
    NaN at the first masked slot of row 1; the cotangent, with a NaN at
    that slot where ``nan_cot``."""
    x = (rng.randn(*shape) * 3).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    x[..., 0, :, 2, :] = -np.inf
    at = tuple(np.argwhere(~live[..., 0, :, 1, :])[0])
    idx = (Ellipsis, 0, at[-2], 1, at[-1])
    x[idx] = np.nan
    if nan_cot:
        g[idx] = np.nan
    return x, g


@pytest.mark.parametrize("nan_cot", [False, True])
@pytest.mark.parametrize("replicas", [0, 3])
def test_ell_panel_softmax_modes_match_jax(xla, replicas, nan_cot):
    """``panel_api.sparse_softmax`` on an ELL spec, with and without a
    replica axis, vs ``jax.vjp`` of ``sputnik_tpu.ops.panel_api.
    sparse_softmax`` at the same tiles."""
    rng = np.random.RandomState(21 + replicas + nan_cot)
    mask = _causal_problem(rng, 40, 0.6)
    t = stt.SparseTopology.from_dense_mask(mask)
    jt = JTopology.from_dense_mask(mask)
    spec, jspec = P.PanelSpec(t, 16, 8), JP.PanelSpec(jt, 16, 8)
    assert spec.view.values_shape == jspec.view.values_shape
    np.testing.assert_array_equal(spec.view.mask, jspec.view.mask)
    assert spec.view.nblocks.min() < spec.view.max_bpr  # absent tiles
    shape = ((replicas,) if replicas else ()) + spec.view.values_shape
    live = np.broadcast_to(spec.view.mask != 0, shape)
    x, g = _panel_inputs(rng, shape, live, nan_cot)
    def jfn(v):
        return JP.sparse_softmax(jspec, v)

    # JAX's ELL softmax takes one panel: replicas through vmap
    (jp, jdx), (tp, tdx) = _vjp_both(
        jax.vmap(jfn) if replicas else jfn,
        lambda v: P.sparse_softmax(spec, v), x, g)
    _close(tp, jp)
    _close(tdx, jdx)
    tp = tp.detach()
    assert torch.all(tp[torch.from_numpy(~live.copy())] == 0)
    assert torch.all(tp[..., 0, :, 2, :] == 0)
    nan_rows = np.isnan(jdx).any(axis=(-3, -1))
    assert nan_rows.sum() == (max(replicas, 1) if nan_cot else 0)
    np.testing.assert_array_equal(torch.isnan(tdx).any(-1).any(-2).numpy(),
                                  nan_rows)


@pytest.mark.parametrize("nan_cot", [False, True])
def test_batched_softmax_modes_match_jax(xla, nan_cot):
    """``sparse_softmax_bh`` with two masks x two heads vs ``jax.vjp`` of
    ``sputnik_tpu.ops.batched_panel.sparse_softmax_bh`` at the same
    tiles."""
    rng = np.random.RandomState(31 + nan_cot)
    masks = np.stack([_causal_problem(rng, 40, d) for d in (1.0, 0.5)])
    spec = stt.BatchedPanelSpec.from_many_mask(
        tmm.ManyMaskTopology.from_dense_masks(masks), heads=2, bm=16, bk=8)
    jspec = JB.BatchedPanelSpec.from_many_mask(
        jmm.ManyMaskTopology.from_dense_masks(masks), heads=2, bm=16, bk=8)
    shape = (spec.R,) + spec.panel_shape
    np.testing.assert_array_equal(spec.meta["mask"], jspec.meta["mask"])
    live = (spec.meta["mask"] != 0).repeat(2, axis=0)
    assert (spec.meta["nblocks"] < spec.max_bpr).any()  # absent tiles
    x, g = _panel_inputs(rng, shape, live, nan_cot)
    (jp, jdx), (tp, tdx) = _vjp_both(
        lambda v: JB.sparse_softmax_bh(jspec, v),
        lambda v: stt.sparse_softmax_bh(spec, v), x, g)
    _close(tp, jp)
    _close(tdx, jdx)
    tp = tp.detach()
    assert torch.all(tp[torch.from_numpy(~live)] == 0)
    assert torch.all(tp[:, 0, :, 2] == 0) and torch.all(tp[:, 0, :, 6] == 0)
    nan_rows = np.isnan(jdx).any(axis=(-3, -1))
    assert nan_rows.sum() == (spec.R if nan_cot else 0)
    np.testing.assert_array_equal(torch.isnan(tdx).any(-1).any(-2).numpy(),
                                  nan_rows)


def test_batched_softmax_computes_bf16_in_f32():
    """A deliberate difference: ``sparse_softmax_bh`` computes a bf16 panel
    in f32, B5's type, and returns bf16, as ``panel_api.sparse_softmax``
    does (JAX's computes in bf16); its gradient comes back in bf16."""
    rng = np.random.RandomState(51)
    masks = np.stack([_causal_problem(rng, 40, d) for d in (1.0, 0.5)])
    spec = stt.BatchedPanelSpec.from_many_mask(
        tmm.ManyMaskTopology.from_dense_masks(masks), heads=2, bm=16, bk=8)
    x = torch.from_numpy((rng.randn(spec.R, *spec.panel_shape) * 3).astype(
        np.float32)).bfloat16().requires_grad_()
    p = stt.sparse_softmax_bh(spec, x)
    assert p.dtype == torch.bfloat16
    ref = stt.sparse_softmax_bh(spec, x.detach().float())
    assert torch.equal(p.detach(), ref.bfloat16())
    p.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16


def test_softmax_wrappers_take_the_plain_route_on_cpu():
    """On CPU tensors the four wrappers return their plain versions' values
    and launch nothing (no build is attempted: there is no nvcc here)."""
    from sputnik_tpu_torch.ops import plain_ops

    wrappers = kernel_wrappers()
    before = {n: w.launches for n, w in wrappers.items()}
    rng = np.random.RandomState(41)
    t = stt.SparseTopology.from_dense_mask(rng.rand(20, 30) < 0.4,
                                           pad_to=8)
    ro = torch.from_numpy(t.row_offsets)
    ri = torch.from_numpy(t.row_ids.astype(np.int64))
    v, g = (torch.from_numpy(rng.randn(2, t.nnz_pad).astype(np.float32))
            for _ in range(2))
    p = K.ell_softmax_kernel(ro, ri, v, nnz=t.nnz)
    assert torch.equal(p, plain_ops.sparse_softmax(v, ri, ri < t.m, t.m))
    assert torch.equal(K.ell_softmax_bwd_kernel(ro, ri, p, g, nnz=t.nnz),
                       plain_ops.softmax_vjp(p, g, ri, t.m))
    spec = P.PanelSpec(t, 8, 8)
    meta = spec.meta("cpu")
    mask, nblocks = meta["mask"][None], meta["nblocks"][None]
    x, g = (torch.from_numpy(rng.randn(4, *spec.view.values_shape).astype(
        np.float32)) for _ in range(2))
    p = K.panel_softmax_kernel(mask, nblocks, x, heads=4)
    assert torch.equal(p, K.masked_softmax_plain(x, mask, 4))
    assert torch.equal(K.panel_softmax_bwd_kernel(p, g),
                       K.masked_softmax_vjp_plain(p, g))
    assert {n: w.launches for n, w in wrappers.items()} == before
    with pytest.raises(ValueError):
        K.panel_softmax_kernel(mask, nblocks, x, heads=3)   # 1 * 3 != 4
