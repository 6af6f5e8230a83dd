"""The port's flat op set (``sputnik_tpu_torch.ops.api``) against the JAX
package's (``sputnik_tpu.ops.api``), on the CPU.

Both packages run under the same ``set_backend``: ``"xla"`` (the port's
``plain_ops`` oracle against JAX's XLA oracle) and ``"pallas"`` (the port's
panel route on its kernels' plain versions, B5's included, against JAX's
Pallas kernels in interpret mode). The classes mirror ``tests/test_ops.py``;
then B5's plain versions against the JAX kernel, float64 ``gradcheck`` on
both routes, and a seeded differential fuzzer over shape, density, replicas,
empty rows and empty columns.

Tolerance: atol = rtol = 1e-4 on every op and gradient (f32 on both sides),
tighter than the reference's 1e-2 for matmul-class ops; SDDMM and softmax at
the reference's 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu.ops.pallas import ell_softmax as jell
from sputnik_tpu.patterns import init_uniform, sparsify_uniform
from sputnik_tpu.topology import SparseTopology as JTopology
from sputnik_tpu_torch.ops import plain_ops
from sputnik_tpu_torch.ops.kernels.ell_softmax import (ell_softmax_kernel,
                                                       ell_softmax_panel)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(params=["xla", "pallas"])
def backend(request):
    st.set_backend(request.param)
    stt.set_backend(request.param)
    try:
        yield request.param
    finally:
        st.set_backend("auto")
        stt.set_backend("auto")


def _pair(dense):
    """The same matrix in both packages: (jax SparseMatrix, port's)."""
    return st.SparseMatrix(dense), stt.SparseMatrix(dense)


def make_sparse(m, k, sparsity, seed=0):
    dense = sparsify_uniform(init_uniform((m, k), seed=seed), sparsity,
                             round_to=4, seed=seed + 1).astype(np.float32)
    return (dense,) + _pair(dense)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else got, np.asarray(ref, np.float32), **tol)


class TestSpmm:
    @pytest.mark.parametrize("m,k,n,sparsity", [
        (72, 64, 72, 0.9), (72, 64, 72, 0.0), (33, 47, 29, 0.8)])
    def test_2d_parity(self, backend, m, k, n, sparsity):
        dense_a, jm, tm = make_sparse(m, k, sparsity)
        b = init_uniform((k, n), seed=7)
        ref = st.spmm(jm.topology, jnp.asarray(jm.values), jnp.asarray(b))
        got = stt.spmm(tm.topology, _t(tm.values), _t(b))
        _close(got, ref)
        _close(got, dense_a @ b)

    def test_3d_replicated(self, backend):
        r, m, k, n = 4, 40, 32, 24
        _, jm, tm = make_sparse(m, k, 0.8)
        t = tm.topology
        vals = init_uniform((r, t.nnz_pad), seed=3) * t.valid
        b = init_uniform((r, k, n), seed=4)
        ref = st.spmm(jm.topology, jnp.asarray(vals), jnp.asarray(b))
        got = stt.spmm(t, _t(vals), _t(b))
        assert got.shape == (r, m, n)
        _close(got, ref)

    def test_left_spmm(self, backend):
        r, m, k, n = 4, 48, 32, 24
        _, jm, tm = make_sparse(m, k, 0.7)
        b = init_uniform((r, k, n), seed=5)
        ref = st.left_spmm(jm.topology, jnp.asarray(jm.values),
                           jnp.asarray(b))
        got = stt.left_spmm(tm.topology, _t(tm.values), _t(b))
        assert got.shape == (r, m, n)
        _close(got, ref)

    def test_empty_row_gives_zeros(self, backend):
        dense = init_uniform((8, 8), seed=1)
        dense[3, :] = 0
        _, tm = _pair(dense)
        out = stt.spmm(tm.topology, _t(tm.values), _t(init_uniform((8, 4))))
        assert torch.all(out[3] == 0)

    def test_rank_errors(self):
        _, _, tm = make_sparse(16, 12, 0.5)
        t, v = tm.topology, _t(tm.values)
        with pytest.raises(ValueError, match="dense rows"):
            stt.spmm(t, v, torch.zeros(13, 4))
        with pytest.raises(ValueError, match="bad ranks"):
            stt.spmm(t, v, torch.zeros(2, 12, 4))
        with pytest.raises(ValueError, match="1-D"):
            stt.left_spmm(t, v[None], torch.zeros(2, 12, 4))
        with pytest.raises(ValueError, match="bad dense rank"):
            stt.left_spmm(t, v, torch.zeros(1, 2, 12, 4))
        with pytest.raises(ValueError, match="lhs rows"):
            stt.sddmm(t, torch.zeros(15, 4), torch.zeros(12, 4))
        with pytest.raises(ValueError, match="bad ranks"):
            stt.sddmm(t, torch.zeros(16, 4), torch.zeros(1, 12, 4))
        with pytest.raises(ValueError, match="bad values rank"):
            stt.sparse_softmax(t, v[None, None])
        with pytest.raises(ValueError, match="bias must be"):
            stt.spmm_bias_relu(t, v, torch.zeros(12, 4), torch.zeros(15))


class TestSddmm:
    @pytest.mark.parametrize("sparsity", [0.9, 0.0])
    def test_2d_parity(self, backend, sparsity):
        m, n, d = 72, 72, 64
        mask, jm, tm = make_sparse(m, n, sparsity, seed=10)
        lhs, rhs = init_uniform((m, d), seed=11), init_uniform((n, d),
                                                                seed=12)
        t = tm.topology
        ref = st.sddmm(jm.topology, jnp.asarray(lhs), jnp.asarray(rhs))
        got = stt.sddmm(t, _t(lhs), _t(rhs))
        _close(got, ref)
        assert torch.all(got[t.nnz:] == 0)

    def test_3d_parity(self, backend):
        r, m, n, d = 3, 48, 40, 16
        _, jm, tm = make_sparse(m, n, 0.8, seed=13)
        lhs, rhs = init_uniform((r, m, d), seed=14), init_uniform((r, n, d),
                                                                   seed=15)
        ref = st.sddmm(jm.topology, jnp.asarray(lhs), jnp.asarray(rhs))
        got = stt.sddmm(tm.topology, _t(lhs), _t(rhs))
        assert got.shape == (r, tm.topology.nnz_pad)
        _close(got, ref)


class TestSoftmax:
    def test_parity_with_empty_row_and_padding(self, backend):
        dense = init_uniform((40, 36), seed=21) * (
            np.random.RandomState(20).rand(40, 36) < 0.2)
        dense[6] = 0                           # an empty row
        _, jm, tm = (None,) + _pair(dense.astype(np.float32))
        t = tm.topology
        vals = init_uniform((t.nnz_pad,), low=-3, high=3, seed=22)
        ref = st.sparse_softmax(jm.topology, jnp.asarray(vals))
        got = stt.sparse_softmax(t, _t(vals))
        _close(got, ref)
        assert torch.all(got[t.nnz:] == 0)
        sums = np.zeros(t.m + 1)
        np.add.at(sums, t.row_ids, got.numpy())
        np.testing.assert_allclose(sums[: t.m][t.row_lengths > 0], 1.0,
                                   rtol=1e-5)

    def test_replicated(self, backend):
        r = 5
        _, jm, tm = make_sparse(32, 32, 0.8, seed=25)
        t = tm.topology
        vals = init_uniform((r, t.nnz_pad), seed=26) * t.valid
        ref = st.sparse_softmax(jm.topology, jnp.asarray(vals))
        got = stt.sparse_softmax(t, _t(vals))
        assert got.shape == (r, t.nnz_pad)
        _close(got, ref)

    def test_minus_inf_row_gives_zeros(self, backend):
        _, jm, tm = make_sparse(16, 16, 0.5, seed=27)
        t = tm.topology
        vals = init_uniform((t.nnz_pad,), seed=28)
        lo, hi = t.row_offsets[2], t.row_offsets[3]
        vals[lo:hi] = -np.inf
        ref = st.sparse_softmax(jm.topology, jnp.asarray(vals))
        got = stt.sparse_softmax(t, _t(vals))
        assert torch.isfinite(got).all() and torch.all(got[lo:hi] == 0)
        _close(got, ref)


class TestTransposeOp:
    def test_transpose_then_spmm_is_atb(self, backend):
        m, k, n = 48, 40, 24
        dense_a, jm, tm = make_sparse(m, k, 0.8, seed=30)
        b = init_uniform((m, n), seed=31)
        jt_t, jv_t = st.csr_transpose(jm.topology, jnp.asarray(jm.values))
        tt_t, tv_t = stt.csr_transpose(tm.topology, _t(tm.values))
        _close(tv_t, jv_t)
        got = stt.spmm(tt_t, tv_t, _t(b))
        _close(got, st.spmm(jt_t, jv_t, jnp.asarray(b)))
        _close(got, dense_a.T @ b)

    def test_batched_values(self):
        r = 3
        _, jm, tm = make_sparse(16, 24, 0.7, seed=32)
        vals = init_uniform((r, tm.topology.nnz_pad), seed=33)
        _, jv = st.csr_transpose(jm.topology, jnp.asarray(vals))
        tt, tv = stt.csr_transpose(tm.topology, _t(vals))
        assert tv.shape == (r, tt.nnz_pad)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


class TestSpmmBiasRelu:
    @pytest.mark.parametrize("rank", [2, 3])
    def test_parity(self, backend, rank):
        m, k, n = 40, 32, 24
        _, jm, tm = make_sparse(m, k, 0.5, seed=41)
        shape = (k, n) if rank == 2 else (3, k, n)
        b = init_uniform(shape, low=-1.0, high=1.0, seed=42)
        bias = init_uniform((m,), low=-2.0, high=1.0, seed=43)
        ref = st.spmm_bias_relu(jm.topology, jnp.asarray(jm.values),
                                jnp.asarray(b), jnp.asarray(bias))
        got = stt.spmm_bias(tm.topology, _t(tm.values), _t(b), _t(bias))
        _close(got, ref)
        assert (got >= 0).all()

    def test_replicated_values(self, backend):
        r, m, k, n = 3, 24, 16, 8
        _, jm, tm = make_sparse(m, k, 0.6, seed=44)
        vals = init_uniform((r, tm.topology.nnz_pad), seed=45) * \
            tm.topology.valid
        b = init_uniform((r, k, n), low=-1.0, high=1.0, seed=46)
        bias = init_uniform((m,), low=-0.5, high=0.5, seed=47)
        ref = st.spmm_bias_relu(jm.topology, jnp.asarray(vals),
                                jnp.asarray(b), jnp.asarray(bias))
        _close(stt.spmm_bias_relu(tm.topology, _t(vals), _t(b), _t(bias)),
               ref)


def _vjp_both(jf, tf, jargs, targs, seed):
    """Outputs and input gradients of ``jf`` (jax.vjp) and ``tf``
    (autograd) for one seeded cotangent."""
    ref, vjp = jax.vjp(jf, *jargs)
    g = np.random.RandomState(seed).randn(*ref.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(g))
    targs = [a.clone().requires_grad_() for a in targs]
    out = tf(*targs)
    out.backward(_t(g))
    return (out, ref), [(a.grad, jg) for a, jg in zip(targs, jgrads)]


class TestGrads:
    def test_spmm_grads(self, backend):
        _, jm, tm = make_sparse(40, 32, 0.75, seed=50)
        b = init_uniform((32, 16), seed=51)
        jt, t = jm.topology, tm.topology
        outs, grads = _vjp_both(
            lambda v, d: st.spmm(jt, v, d), lambda v, d: stt.spmm(t, v, d),
            (jnp.asarray(jm.values), jnp.asarray(b)),
            (_t(tm.values), _t(b)), 52)
        for got, ref in [outs] + grads:
            _close(got, ref)
        assert torch.all(grads[0][0][t.nnz:] == 0)

    def test_left_spmm_values_grad_sums_replicas(self, backend):
        _, jm, tm = make_sparse(24, 20, 0.6, seed=53)
        b = init_uniform((3, 20, 8), seed=54)
        jt, t = jm.topology, tm.topology
        outs, grads = _vjp_both(
            lambda v, d: st.left_spmm(jt, v, d),
            lambda v, d: stt.left_spmm(t, v, d),
            (jnp.asarray(jm.values), jnp.asarray(b)),
            (_t(tm.values), _t(b)), 55)
        for got, ref in [outs] + grads:
            _close(got, ref)

    def test_sddmm_grads(self, backend):
        _, jm, tm = make_sparse(36, 28, 0.75, seed=56)
        lhs, rhs = init_uniform((2, 36, 8), seed=57), init_uniform(
            (2, 28, 8), seed=58)
        jt, t = jm.topology, tm.topology
        outs, grads = _vjp_both(
            lambda a, b: st.sddmm(jt, a, b), lambda a, b: stt.sddmm(t, a, b),
            (jnp.asarray(lhs), jnp.asarray(rhs)), (_t(lhs), _t(rhs)), 59)
        for got, ref in [outs] + grads:
            _close(got, ref)

    def test_softmax_grad(self, backend):
        _, jm, tm = make_sparse(32, 32, 0.8, seed=60)
        t = tm.topology
        vals = init_uniform((2, t.nnz_pad), seed=61) * t.valid
        outs, grads = _vjp_both(
            lambda v: st.sparse_softmax(jm.topology, v),
            lambda v: stt.sparse_softmax(t, v), (jnp.asarray(vals),),
            (_t(vals),), 62)
        for got, ref in [outs] + grads:
            _close(got, ref)
        assert torch.all(grads[0][0][:, t.nnz:] == 0)

    def test_bias_relu_grads(self, backend):
        _, jm, tm = make_sparse(24, 16, 0.6, seed=63)
        b = init_uniform((16, 8), low=-1.0, high=1.0, seed=64)
        bias = init_uniform((24,), low=-0.5, high=0.5, seed=65)
        jt, t = jm.topology, tm.topology
        outs, grads = _vjp_both(
            lambda v, d, bb: st.spmm_bias_relu(jt, v, d, bb),
            lambda v, d, bb: stt.spmm_bias_relu(t, v, d, bb),
            (jnp.asarray(jm.values), jnp.asarray(b), jnp.asarray(bias)),
            (_t(tm.values), _t(b), _t(bias)), 66)
        for got, ref in [outs] + grads:
            _close(got, ref)

    def test_attention_chain_grads(self, backend):
        """sddmm -> scale -> sparse_softmax -> spmm on replicated values,
        the reference's attention chain, with an empty row."""
        s, r, d = 32, 2, 8
        mask = (np.random.RandomState(67).rand(s, s) < 0.3).astype(
            np.float32)
        mask[4] = 0.0
        jt, t = JTopology.from_dense_mask(mask), \
            stt.SparseTopology.from_dense_mask(mask)
        q, k, v = (init_uniform((r, s, d), low=-1, high=1, seed=68 + i)
                   for i in range(3))

        def chain(pkg, topo):
            def f(q, k, v):
                p = pkg.sparse_softmax(topo, pkg.sddmm(topo, q, k) * 0.5)
                return pkg.spmm(topo, p, v)
            return f

        outs, grads = _vjp_both(
            chain(st, jt), chain(stt, t), tuple(map(jnp.asarray, (q, k, v))),
            tuple(map(_t, (q, k, v))), 71)
        for got, ref in [outs] + grads:
            _close(got, ref)
        assert torch.all(outs[0][:, 4] == 0)

    @pytest.mark.parametrize("op", ["spmm", "left_spmm", "sddmm", "softmax",
                                    "bias_relu", "transpose"])
    def test_gradcheck_float64(self, backend, op):
        """``torch.autograd.gradcheck`` in float64 on both routes (the panel
        route runs the kernels' plain versions in float64 here)."""
        rng = np.random.RandomState(72)
        mask = rng.rand(12, 10) < 0.4
        mask[3] = False
        t = stt.SparseTopology.from_dense_mask(mask)

        def f64(*shape):
            return torch.from_numpy(rng.randn(*shape)).requires_grad_()

        v = f64(t.nnz_pad)
        fns = {
            "spmm": (lambda v, d: stt.spmm(t, v, d), (v, f64(10, 5))),
            "left_spmm": (lambda v, d: stt.left_spmm(t, v, d),
                          (v, f64(2, 10, 3))),
            "sddmm": (lambda a, b: stt.sddmm(t, a, b),
                      (f64(2, 12, 4), f64(2, 10, 4))),
            "softmax": (lambda v: stt.sparse_softmax(t, v),
                        (f64(2, t.nnz_pad),)),
            # a bias away from 0 keeps ReLU's kink out of the differences
            "bias_relu": (lambda v, d, b: stt.spmm_bias_relu(t, v, d, b),
                          (v, f64(10, 5),
                           (torch.from_numpy(rng.rand(12) + 4.0)
                            * torch.from_numpy(rng.choice([-1.0, 1.0], 12))
                            ).requires_grad_())),
            "transpose": (lambda v: stt.csr_transpose(t, v)[1], (v,)),
        }
        fn, args = fns[op]
        assert torch.autograd.gradcheck(fn, args)


def test_flat_api_mixed_dtype_grads(backend):
    """bf16 / f32 mixed primals: outputs take the promoted dtype and every
    gradient its primal's dtype (``tests/test_ops.py``'s check)."""
    rng = np.random.RandomState(21)
    A = ((rng.rand(48, 40) < 0.4) * rng.randn(48, 40)).astype(np.float32)
    t = stt.SparseMatrix(A).topology
    vals16 = _t(stt.SparseMatrix(A).values).to(torch.bfloat16)
    dense, bias = _t(rng.randn(40, 24).astype(np.float32)), \
        _t(rng.randn(48).astype(np.float32))

    def grads(fn, *args):
        args = [a.clone().requires_grad_() for a in args]
        out = fn(*args)
        out.float().sum().backward()
        return out, [a.grad for a in args]

    out, (gv, gd) = grads(lambda v, d: stt.spmm(t, v, d), vals16, dense)
    assert out.dtype == torch.float32
    assert gv.dtype == torch.bfloat16 and gd.dtype == torch.float32
    _, (gv, gd, gb) = grads(lambda v, d, b: stt.spmm_bias_relu(t, v, d, b),
                            vals16, dense, bias)
    assert gv.dtype == torch.bfloat16 and gb.dtype == torch.float32
    lhs16 = _t(rng.randn(48, 24).astype(np.float32)).to(torch.bfloat16)
    _, (gl, gr) = grads(lambda a, b: stt.sddmm(t, a, b), lhs16,
                        _t(rng.randn(40, 24).astype(np.float32)))
    assert gl.dtype == torch.bfloat16 and gr.dtype == torch.float32
    _, (gs,) = grads(lambda v: stt.sparse_softmax(t, v), vals16)
    assert gs.dtype == torch.bfloat16


# -- B5's plain versions against the JAX kernel (interpret mode) -------------


def _softmax_case(seed, m=24, n=40, r=3, density=0.3, pad_to=8):
    rng = np.random.RandomState(seed)
    mask = rng.rand(m, n) < density
    mask[5] = False                                   # an empty row
    mask[9] = True                                    # a full row
    t = stt.SparseTopology.from_dense_mask(mask, pad_to=pad_to)
    jt = JTopology.from_dense_mask(mask, pad_to=pad_to)
    vals = (rng.randn(r, t.nnz_pad) * 3).astype(np.float32)
    lo, hi = t.row_offsets[11], t.row_offsets[12]
    vals[:, lo:hi] = -np.inf                          # a row of -inf scores
    vals[:, lo + 1: hi: 2] = -1e35
    return t, jt, vals, (lo, hi)


def test_ell_softmax_plain_matches_the_jax_kernel():
    t, jt, vals, (lo, hi) = _softmax_case(80)
    assert t.nnz_pad > t.nnz and hi > lo
    ro = torch.from_numpy(t.row_offsets)
    ri = torch.from_numpy(t.row_ids.astype(np.int64))
    got = ell_softmax_kernel(ro, ri, _t(vals), nnz=t.nnz)   # CPU: the plain
    for i in range(vals.shape[0]):
        ref = jell.ell_softmax(jt, jnp.asarray(vals[i]), interpret=True)
        _close(got[i], ref, dict(atol=1e-6, rtol=1e-5))
        one = plain_ops.sparse_softmax(_t(vals[i]), t.row_ids, t.valid, t.m)
        np.testing.assert_array_equal(got[i].numpy(), one.numpy())
    assert torch.all(got[:, t.nnz:] == 0) and torch.all(got[:, lo:hi] == 0)


def test_ell_softmax_panel_matches_the_jax_kernel():
    t, jt, vals, _ = _softmax_case(81)
    ev = t.ell(lane=128)
    rng = np.random.RandomState(82)
    panel = rng.randn(8 * 3, ev.l_pad).astype(np.float32)
    mask = np.zeros_like(panel)
    mask[: ev.m] = ev.mask
    panel[2, :] = -np.inf
    ref = jell.ell_softmax_panel(jnp.asarray(panel), jnp.asarray(mask),
                                 interpret=True)
    got = ell_softmax_panel(_t(panel), _t(mask))
    _close(got, ref, dict(atol=1e-6, rtol=1e-5))
    assert torch.all(got[mask == 0] == 0)


# -- the seeded differential fuzzer -----------------------------------------


def _fuzz_case(seed):
    """Shape, density, replicas, empty rows and empty columns from one
    seed."""
    rng = np.random.RandomState(1000 + seed)
    m, k = rng.randint(1, 70, size=2)
    n, d = rng.randint(1, 24, size=2)
    density = rng.choice([0.02, 0.1, 0.3, 0.7, 1.0])
    mask = rng.rand(m, k) < density
    for axis in (0, 1):
        if rng.rand() < 0.5:                          # empty rows / columns
            drop = rng.rand(mask.shape[axis]) < 0.3
            if axis == 0:
                mask[drop] = False
            else:
                mask[:, drop] = False
    reps = int(rng.choice([0, 2]))
    return rng, mask, int(n), int(d), reps


def _dense_chain(mask, v, x, a, b, reps):
    """The fuzzer's chain on dense float64 matrices: the reference both
    routes are held against."""
    live = torch.from_numpy(mask)
    scores = torch.where(live, a @ b.transpose(-1, -2) + v, -torch.inf)
    p = torch.where(live, torch.softmax(scores, dim=-1), 0.0)
    p = torch.nan_to_num(p)                           # empty rows: 0
    y = p @ x
    if not reps:
        y = y + v @ x
    return y, p


@pytest.mark.parametrize("seed", range(36))
def test_differential_fuzz(seed):
    """Random cases through both routes of the port against the same
    function on dense float64 matrices: sddmm, sparse_softmax, spmm /
    left_spmm and csr_transpose, forward and every input's gradient."""
    rng, mask, n, d, reps = _fuzz_case(seed)
    m, k = mask.shape
    t = stt.SparseTopology.from_dense_mask(mask)
    lead = (reps,) if reps else ()
    vals = (rng.randn(*lead, t.nnz_pad) * t.valid).astype(np.float32)
    dense = rng.randn(*lead, k, n).astype(np.float32)
    lhs, rhs = (rng.randn(*lead, m, d).astype(np.float32),
                rng.randn(*lead, k, d).astype(np.float32))
    g = rng.randn(*lead, m, n).astype(np.float32)
    rows, cols = t.row_ids[: t.nnz], t.column_indices[: t.nnz]

    def to_dense(v):                                  # [.., nnz_pad] -> mat
        out = torch.zeros(*v.shape[:-1], m, k, dtype=v.dtype)
        out[..., rows, cols] = v[..., : t.nnz]
        return out

    args64 = [_t(a).double().requires_grad_() for a in
              (vals, dense, lhs, rhs)]
    y_ref, p_ref = _dense_chain(mask, to_dense(args64[0]), *args64[1:],
                                reps)
    y_ref.backward(_t(g).double())
    _, perm = t.transpose()
    for route in ("xla", "pallas"):
        stt.set_backend(route)
        try:
            args = [_t(a).requires_grad_() for a in (vals, dense, lhs, rhs)]
            v, x, a, b = args
            p = stt.sparse_softmax(t, stt.sddmm(t, a, b) + v)
            y = stt.spmm(t, p, x)
            if not reps:
                y = y + stt.left_spmm(t, v, x[None])[0]
            y.backward(_t(g))
            t_t, p_t = stt.csr_transpose(t, p)
        finally:
            stt.set_backend("auto")
        _close(y, y_ref.detach())
        _close(to_dense(p), p_ref.detach())
        assert t_t.m == k and torch.equal(p_t, p[..., perm])
        assert torch.all(p[..., t.nnz:] == 0)
        grads = [to_dense(args[0].grad), *[a.grad for a in args[1:]]]
        want = [to_dense(args64[0].grad), *[a.grad for a in args64[1:]]]
        for got, ref in zip(grads, want):
            _close(got, ref)
