"""Gradients of the port's panel ops (autograd Functions running the plain
versions on the CPU) against ``jax.vjp`` through the JAX package's
``custom_vjp`` panel ops, under its XLA oracle and its Pallas kernels in
interpret mode; ``spmm_t``'s forward and the plain transposed SpMM against
the JAX kernel; ``torch.autograd.gradcheck`` in float64 on every Function.

Panel gradients are compared as CSR values on both sides (the packages tile
differently). Tolerance atol = rtol = 1e-4 (f32 on both sides).
"""

import jax
import numpy as np
import pytest
import torch

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu.ops import panel_api as JP
from sputnik_tpu.ops.pallas import bsr_spmm_t as jspmm_t
from sputnik_tpu.topology import SparseTopology as JTopology
from sputnik_tpu_torch.ops import panel_api as P
from sputnik_tpu_torch.ops.kernels.bsr_spmm_t import bsr_spmm_t_panel_plain

TOL = dict(atol=1e-4, rtol=1e-4)
M, N, Q, D, R = 48, 40, 24, 20, 2
TILES = (16, 32)           # the port's tiles here: several row/column blocks


@pytest.fixture(params=["xla", "pallas"])
def backend(request):
    st.set_backend(request.param)
    try:
        yield request.param
    finally:
        st.set_backend("auto")


@pytest.fixture(scope="module")
def prob():
    rng = np.random.RandomState(7)
    mask = (rng.rand(M, N) < 0.3).astype(np.float32)
    mask[9] = 0.0                       # an empty row
    mask[:, :TILES[1]] = 0.0            # an empty block column (port tiles)
    jt = JTopology.from_dense_mask(mask)
    t = stt.SparseTopology.from_dense_mask(mask)
    nnz = t.nnz
    vals = np.zeros(t.nnz_pad, np.float32)
    vals[:nnz] = rng.randn(nnz)
    return dict(mask=mask, jt=jt, t=t, jspec=JP.PanelSpec(jt),
                spec=P.PanelSpec(t, *TILES), rng=rng,
                vals=np.stack([vals * (r + 1) for r in range(R)]))


def _jpanel(p, vals):
    js = p["jspec"]
    return JP.values_to_panel_np(p["jt"], vals, js.bm, js.bk)


def _tpanel(p, vals):
    return P.values_to_panel_np(p["t"], vals, *TILES)


def _jvals(p, panel):
    js = p["jspec"]
    return JP.panel_to_values_np(p["jt"], np.asarray(panel), js.bm, js.bk)


def _tvals(p, panel):
    return P.panel_to_values_np(p["t"], panel.detach().numpy(), *TILES)


# Each case: JAX fn over one replica, port fn (replicated or not), which
# arguments are panels, and the shapes of the dense arguments.
def _case(name, p):
    rng = np.random.RandomState(11)
    js, ts = p["jspec"], p["spec"]
    bias = rng.randn(M).astype(np.float32)
    dense_n = rng.randn(R, N, Q).astype(np.float32)
    dense_m = rng.randn(R, M, Q).astype(np.float32)
    lhs = rng.randn(R, M, D).astype(np.float32)
    rhs = rng.randn(R, N, D).astype(np.float32)
    jb, tb = bias, torch.from_numpy(bias)
    if name == "spmm":
        return (lambda a, d: JP.spmm(js, a, d),
                lambda a, d: P.spmm(ts, a, d), (True, dense_n))
    if name == "spmm_bias":
        return (lambda a, d: JP.spmm(js, a, d) + jb[:, None],
                lambda a, d: P.spmm_bias(ts, a, d, tb), (True, dense_n))
    if name == "spmm_bias_relu":
        return (lambda a, d: JP.spmm_bias_relu(js, a, d, jb),
                lambda a, d: P.spmm_bias_relu(ts, a, d, tb), (True, dense_n))
    if name == "spmm_t":
        return (lambda a, d: JP.spmm_t(js, a, d),
                lambda a, d: P.spmm_t(ts, a, d), (True, dense_m))
    if name == "sddmm":
        return (lambda a, b: JP.sddmm(js, a, b),
                lambda a, b: P.sddmm(ts, a, b), (False, lhs, rhs))
    if name == "sparse_softmax":
        return (lambda a: JP.sparse_softmax(js, a),
                lambda a: P.sparse_softmax(ts, a), (True,))
    raise KeyError(name)


OPS = ["spmm", "spmm_bias", "spmm_bias_relu", "spmm_t", "sddmm",
       "sparse_softmax"]


@pytest.mark.parametrize("replicated", [False, True])
@pytest.mark.parametrize("op", OPS)
def test_gradients_match_jax(backend, prob, op, replicated):
    jfn, tfn, spec_args = _case(op, prob)
    panel_in, dense = spec_args[0], list(spec_args[1:])
    reps = range(R) if replicated else range(1)
    out_panel = op in ("sddmm", "sparse_softmax")
    rng = np.random.RandomState(13)

    ref_out, ref_grads = [], []
    t_args = []
    for r in reps:
        args = ([_jpanel(prob, prob["vals"][r])] if panel_in else []) + [
            d[r] for d in dense]
        out, vjp = jax.vjp(jfn, *args)
        out = np.asarray(out)
        cot = rng.randn(*out.shape).astype(np.float32)
        if out_panel:               # a cotangent on the nonzeros only
            cot = cot * (np.abs(np.asarray(_jpanel(
                prob, np.ones(prob["t"].nnz_pad, np.float32)))) > 0)
        grads = vjp(cot)
        ref_out.append(_jvals(prob, out) if out_panel else out)
        ref_grads.append([_jvals(prob, g) if (i == 0 and panel_in)
                          else np.asarray(g) for i, g in enumerate(grads)])
        t_cot = (_tpanel(prob, _jvals(prob, cot)) if out_panel
                 else cot)
        t_args.append(((_tpanel(prob, prob["vals"][r]),) if panel_in else ())
                      + tuple(d[r] for d in dense) + (t_cot,))

    def stack(i):
        x = np.stack([a[i] for a in t_args])
        return torch.from_numpy(x if replicated else x[0]).requires_grad_()

    n_in = len(t_args[0]) - 1
    ins = [stack(i) for i in range(n_in)]
    cot = torch.from_numpy(np.stack([a[-1] for a in t_args])
                           if replicated else t_args[0][-1])
    out = tfn(*ins)
    grads = torch.autograd.grad(out, ins, cot)
    outs = out if replicated else out[None]
    grads = [g if replicated else g[None] for g in grads]
    for r in reps:
        got = _tvals(prob, outs[r]) if out_panel else outs[r].detach().numpy()
        np.testing.assert_allclose(got, ref_out[r], **TOL)
        for i, g in enumerate(grads):
            got = (_tvals(prob, g[r]) if (i == 0 and panel_in)
                   else g[r].numpy())
            np.testing.assert_allclose(got, ref_grads[r][i], **TOL,
                                       err_msg=f"{op} grad {i} replica {r}")
    if panel_in:   # the values' gradient is exactly 0 off the nonzeros
        assert torch.all(grads[0][:, ~prob["spec"].view.mask] == 0)


def test_spmm_t_forward_matches_jax(backend, prob):
    dense = np.random.RandomState(3).randn(M, Q).astype(np.float32)
    ref = np.asarray(JP.spmm_t(prob["jspec"], _jpanel(prob, prob["vals"][0]),
                               dense))
    got = P.spmm_t(prob["spec"], torch.from_numpy(_tpanel(
        prob, prob["vals"][0])), torch.from_numpy(dense))
    assert got.shape == (N, Q)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    t = prob["t"]
    w = np.zeros((M, N), np.float32)
    w[t.row_ids[: t.nnz], t.column_indices[: t.nnz]] = prob["vals"][0][: t.nnz]
    np.testing.assert_allclose(got.numpy(), w.T @ dense, **TOL)


@pytest.mark.parametrize("tiles", [(16, 32), (16, 16)])
def test_plain_spmm_t_matches_pallas_kernel(prob, tiles):
    """The plain transposed SpMM against the JAX kernel in interpret mode at
    the same tiles (so the same panel and transposed metadata), including
    an empty block column: its output rows are exactly 0."""
    bm, bk = tiles
    t = prob["t"]
    spec = P.PanelSpec(t, bm, bk)
    bv = spec.view
    panel = P.values_to_panel_np(t, prob["vals"][0], bm, bk)
    np.testing.assert_array_equal(
        panel, JP.values_to_panel_np(prob["jt"], prob["vals"][0], bm, bk))
    g = np.random.RandomState(5).randn(M, Q).astype(np.float32)
    t_nblocks, t_src = prob["jt"].block(bm, bk).transpose_meta()
    g_pad = np.zeros((bv.mb * bm, 128), np.float32)
    g_pad[:M, :Q] = g
    ref = np.asarray(jspmm_t.bsr_spmm_t_panel(
        t_src[:, :, 0].reshape(-1), t_src[:, :, 1].reshape(-1), t_nblocks,
        panel, g_pad, kb=bv.kb, max_bpc=t_src.shape[1], mb=bv.mb, bm=bm,
        bk=bk, bq=128, interpret=True))[:N, :Q]
    meta = spec.meta("cpu")
    got = bsr_spmm_t_panel_plain(
        meta["t_src_i"], meta["t_src_s"], meta["t_nblocks"],
        torch.from_numpy(panel)[None], torch.from_numpy(g)[None], rows=N)[0]
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    empty = np.flatnonzero(meta["t_nblocks"].numpy() == 0)
    assert empty.size            # the problem has an empty block column
    for j in empty:
        assert np.all(got[j * bk: (j + 1) * bk].numpy() == 0.0)


def _gradcheck_problem():
    rng = np.random.RandomState(17)
    m, n = 10, 12
    mask = rng.rand(m, n) < 0.4
    mask[2] = False
    t = stt.SparseTopology.from_dense_mask(mask)
    return t, P.PanelSpec(t, 4, 8), rng


def _panels(t, spec, vals):
    return torch.stack([P.values_to_panel(t, v, spec.bm, spec.bk)
                        for v in vals])


@pytest.mark.parametrize("op", OPS)
def test_functions_pass_gradcheck(op):
    """float64 ``gradcheck`` of each Function (replicated form) through the
    plain versions; panel inputs enter as CSR values, so the check perturbs
    only the nonzeros, as the op's semantics define them."""
    t, spec, rng = _gradcheck_problem()
    r, q, d = 2, 3, 5

    def f64(*shape):
        return torch.from_numpy(rng.randn(*shape)).requires_grad_()

    vals = f64(r, t.nnz_pad)
    bias = f64(t.m)
    if op == "sddmm":
        fn, args = (lambda a, b: P.sddmm(spec, a, b)), (f64(r, t.m, d),
                                                       f64(r, t.n, d))
    elif op == "sparse_softmax":
        fn, args = (lambda v: P.sparse_softmax(spec, _panels(t, spec, v)),
                    (vals,))
    elif op == "spmm_t":
        fn, args = (lambda v, x: P.spmm_t(spec, _panels(t, spec, v), x),
                    (vals, f64(r, t.m, q)))
    else:
        epi = {"spmm": None, "spmm_bias": P.spmm_bias,
               "spmm_bias_relu": P.spmm_bias_relu}[op]
        if epi is None:
            fn = (lambda v, x: P.spmm(spec, _panels(t, spec, v), x))
            args = (vals, f64(r, t.n, q))
        else:
            fn = (lambda v, x, b: epi(spec, _panels(t, spec, v), x, b))
            args = (vals, f64(r, t.n, q), bias)
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-6)


def test_spmm_t_is_the_transpose_of_spmm():
    """<A x, y> = <x, A^T y> through the two ops, with replicas."""
    t, spec, rng = _gradcheck_problem()
    vals = torch.from_numpy(rng.randn(2, t.nnz_pad))
    panel = _panels(t, spec, vals)
    x = torch.from_numpy(rng.randn(2, t.n, 3))
    y = torch.from_numpy(rng.randn(2, t.m, 3))
    lhs = (P.spmm(spec, panel, x) * y).sum()
    rhs = (x * P.spmm_t(spec, panel, y)).sum()
    assert torch.allclose(lhs, rhs, rtol=1e-12)
