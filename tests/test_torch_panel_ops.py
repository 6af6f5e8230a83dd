"""Panel ops of the PyTorch port (plain versions on the CPU) against the JAX
package's panel API, under both its XLA oracle and its Pallas kernels in
interpret mode. Tiles differ between the packages, so outputs are compared,
never panel bytes. Tolerance atol = rtol = 1e-4 (f32 on both sides).
"""

import numpy as np
import pytest
import torch

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu import many_mask as jmm
from sputnik_tpu.ops import panel_api as JP
from sputnik_tpu.ops import xla_ops
from sputnik_tpu.topology import SparseMatrix as JMatrix
from sputnik_tpu_torch.ops import panel_api as P
from sputnik_tpu_torch.ops import plain_ops

TOL = dict(atol=1e-4, rtol=1e-4)
M, N, Q, D = 48, 40, 24, 20


@pytest.fixture(params=["xla", "pallas"])
def backend(request):
    st.set_backend(request.param)
    try:
        yield request.param
    finally:
        st.set_backend("auto")


@pytest.fixture
def problem():
    rng = np.random.RandomState(3)
    mask = (rng.rand(M, N) < 0.3).astype(np.float32)
    mask[7] = 0.0                                     # an empty row
    w = (mask * rng.randn(M, N)).astype(np.float32)
    jm = JMatrix(w)
    tm = stt.SparseMatrix(w)
    return dict(jm=jm, tm=tm, w=w,
                dense=rng.randn(N, Q).astype(np.float32),
                bias=rng.randn(M).astype(np.float32),
                lhs=rng.randn(M, D).astype(np.float32),
                rhs=rng.randn(N, D).astype(np.float32))


def _jspec(jm):
    return JP.PanelSpec(jm.topology)


def _jpanel(jm):
    sp = _jspec(jm)
    return JP.values_to_panel_np(jm.topology, jm.values, sp.bm, sp.bk)


def _tspec(tm, tiles):
    return P.PanelSpec(tm.topology, *tiles)


def _tpanel(tm, tiles):
    sp = _tspec(tm, tiles)
    return torch.from_numpy(
        P.values_to_panel_np(tm.topology, tm.values, sp.bm, sp.bk))


PORT_TILES = [(64, 64), (16, 32)]


@pytest.mark.parametrize("tiles", PORT_TILES)
@pytest.mark.parametrize("epilogue", ["none", "bias", "bias_relu"])
def test_spmm_epilogues_match(backend, problem, epilogue, tiles):
    jm, tm = problem["jm"], problem["tm"]
    dense, bias = problem["dense"], problem["bias"]
    jspec, jpanel = _jspec(jm), _jpanel(jm)
    if epilogue == "bias_relu":
        ref = JP.spmm_bias_relu(jspec, jpanel, dense, bias)
    else:
        ref = JP.spmm(jspec, jpanel, dense)
        if epilogue == "bias":
            ref = ref + bias[:, None]
    spec, panel = _tspec(tm, tiles), _tpanel(tm, tiles)
    d, b = torch.from_numpy(dense), torch.from_numpy(bias)
    if epilogue == "none":
        got = P.spmm(spec, panel, d)
    elif epilogue == "bias":
        got = P.spmm_bias(spec, panel, d, b)
    else:
        got = P.spmm_bias_relu(spec, panel, d, b)
    assert got.shape == (M, Q)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if epilogue != "none":           # the empty row is exactly its bias
        np.testing.assert_array_equal(
            got[7].numpy(), np.full(Q, bias[7] if epilogue == "bias"
                                    else max(bias[7], 0.0), np.float32))


@pytest.mark.parametrize("tiles", PORT_TILES)
def test_sddmm_and_softmax_match(backend, problem, tiles):
    jm, tm = problem["jm"], problem["tm"]
    lhs, rhs = problem["lhs"], problem["rhs"]
    jspec = _jspec(jm)
    jt = jm.topology
    j_sd = JP.sddmm(jspec, lhs, rhs)
    j_sm = JP.sparse_softmax(jspec, j_sd)
    ref_sd = np.asarray(JP.panel_to_values(jt, j_sd, jspec.bm, jspec.bk))
    ref_sm = np.asarray(JP.panel_to_values(jt, j_sm, jspec.bm, jspec.bk))

    spec = _tspec(tm, tiles)
    t = tm.topology
    sd = P.sddmm(spec, torch.from_numpy(lhs), torch.from_numpy(rhs))
    sm = P.sparse_softmax(spec, sd)
    for panel, ref in ((sd, ref_sd), (sm, ref_sm)):
        vals = P.panel_to_values_np(t, panel.numpy(), spec.bm, spec.bk)
        np.testing.assert_allclose(vals, ref, **TOL)
        # padded slots and masked elements are exactly zero
        assert np.all(panel.numpy()[~spec.view.mask] == 0.0)


def test_replicated_chain_matches_per_replica(backend):
    """[R, ...] replica dimension == JAX ops applied replica by replica."""
    rng = np.random.RandomState(4)
    R, s, hd = 3, 40, 8
    mask = (rng.rand(s, s) < 0.4).astype(np.float32)
    mask[5] = 0.0
    jt = JMatrix(mask).topology
    t = stt.SparseTopology.from_dense_mask(mask)
    q, k, v = (rng.randn(R, s, hd).astype(np.float32) for _ in range(3))
    jspec = JP.PanelSpec(jt)
    ref = np.stack([
        np.asarray(JP.spmm(jspec, JP.sparse_softmax(
            jspec, JP.sddmm(jspec, q[r], k[r])), v[r])) for r in range(R)])
    spec = P.PanelSpec(t)
    w = P.sparse_softmax(spec, P.sddmm(spec, torch.from_numpy(q),
                                       torch.from_numpy(k)))
    got = P.spmm(spec, w, torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert np.all(got[:, 5].numpy() == 0.0)   # empty row -> exactly 0


def test_panel_conversions(problem):
    jm, tm = problem["jm"], problem["tm"]
    t = tm.topology
    for bm, bk in ((16, 16), (64, 64)):
        ref = JP.values_to_panel_np(jm.topology, jm.values, bm, bk)
        np_panel = P.values_to_panel_np(t, tm.values, bm, bk)
        np.testing.assert_array_equal(np_panel, ref)
        tp = P.values_to_panel(t, torch.from_numpy(tm.values), bm, bk)
        np.testing.assert_array_equal(tp.numpy(), ref)
        back = P.panel_to_values(t, tp, bm, bk).numpy()
        np.testing.assert_array_equal(
            back[: t.nnz], P.panel_to_values_np(t, ref, bm, bk)[: t.nnz])
        np.testing.assert_array_equal(back[: t.nnz], tm.values[: t.nnz])


def test_shape_guards(problem):
    tm = problem["tm"]
    spec, panel = _tspec(tm, (64, 64)), _tpanel(tm, (64, 64))
    with pytest.raises(ValueError):
        P.spmm(spec, panel, torch.zeros(N + 1, Q))      # wrong inner dim
    with pytest.raises(ValueError):
        P.spmm(spec, panel, torch.zeros(2, N, Q))       # rank 3, no replicas
    with pytest.raises(ValueError):
        P.sddmm(spec, torch.zeros(M, D), torch.zeros(N - 1, D))


def test_plain_flat_ops_match_xla_ops(problem):
    jm = problem["jm"]
    t = jm.topology
    vals = jm.values
    got = plain_ops.spmm(torch.from_numpy(vals), t.column_indices, t.row_ids,
                         t.m, torch.from_numpy(problem["dense"]))
    ref = xla_ops.spmm(vals, t.column_indices, t.row_ids, t.m,
                       problem["dense"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    got = plain_ops.sddmm(torch.from_numpy(problem["lhs"]),
                          torch.from_numpy(problem["rhs"]), t.row_ids,
                          t.column_indices, t.valid)
    ref = xla_ops.sddmm(problem["lhs"], problem["rhs"], t.row_ids,
                        t.column_indices, t.valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    got = plain_ops.sparse_softmax(got, t.row_ids, t.valid, t.m)
    ref = xla_ops.sparse_softmax(ref, t.row_ids, t.valid, t.m)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_many_mask_ops_match():
    rng = np.random.RandomState(6)
    b, h, s, hd = 2, 2, 24, 8
    masks = (rng.rand(b, s, s) < 0.35).astype(np.float32)
    masks[0, 3] = 0.0
    mt = stt.ManyMaskTopology.from_dense_masks(masks)
    jt = jmm.ManyMaskTopology.from_dense_masks(masks)
    q, k, v = (rng.randn(b * h, s, hd).astype(np.float32) for _ in range(3))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    sc = stt.sddmm_many_mask(mt, tq, tk)
    w = stt.sparse_softmax_many_mask(mt, sc)
    out = stt.spmm_many_mask(mt, w, tv)
    j_sc = jmm.sddmm_many_mask(jt, q, k)
    j_w = jmm.sparse_softmax_many_mask(jt, j_sc)
    j_out = jmm.spmm_many_mask(jt, j_w, v)
    for a, ref in ((sc, j_sc), (w, j_w), (out, j_out)):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **TOL)
    _, vt = stt.csr_transpose_many_mask(mt, w)
    _, j_vt = jmm.csr_transpose_many_mask(jt, j_w)
    np.testing.assert_allclose(vt.numpy(), np.asarray(j_vt), **TOL)
