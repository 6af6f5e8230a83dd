"""The sharded compressed (true-BSR) layout of the PyTorch port against the
JAX package, on the CPU.

  * ``ShardedCompressedSpec``: the common ``G``, the stacked offsets,
    columns, rows, mask and the transposed walk remapped to ``G`` equal
    JAX's; ``stack_values`` equals JAX's on float32 values and keeps the
    values' dtype (JAX's casts to float32: a deliberate difference);
  * ``sharded_spmm_c``, ``sharded_spmm_t_c``, ``sharded_sddmm_c``,
    ``sharded_softmax_c`` and ``sparse_attention_sharded_c``: forward and
    gradients against JAX's on an 8-device CPU mesh;
  * B14's plain version leaves every shard's slots past its own tile count
    exactly 0 (JAX selects them away after its kernel);
  * the ``_c`` ops refuse an ELL spec.

The JAX tests' skewed matrix (``tests/test_sharded_compressed.py``: a band
plus three dense rows, 320 x 1024), bm 8, bk 128. Tolerances: atol 1e-4 on
outputs, 1e-2 on gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu.parallel import RowPartition as JRowPartition
from sputnik_tpu.parallel import sharded_compressed as jsc
from sputnik_tpu_torch.parallel import (RowPartition, ShardedCompressedSpec,
                                        ShardedPanelSpec, sharded_sddmm_c,
                                        sharded_softmax_c, sharded_spmm_c,
                                        sharded_spmm_t_c,
                                        sparse_attention_sharded_c)

NDEV, BM, BK = 8, 8, 128
_ARRAYS = ("block_offsets", "block_cols", "block_rows", "mask", "t_gblk",
           "t_rows", "t_nblocks")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small products, and under
    the suite's parallel workers more threads a worker oversubscribe the
    cores (each test took up to 100x its time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _skewed(rng, m=320, n=1024):
    A = np.zeros((m, n), np.float32)
    for r in range(m):
        lo = max(0, (r * n // m) - 16)
        A[r, lo: lo + 32] = 1.0
    A[7] = A[140] = A[m - 3] = 1.0
    return (A * rng.randn(m, n)).astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(0)
    A = _skewed(rng)
    mat = st.SparseMatrix(A)
    t = mat.topology
    mesh = Mesh(np.array(jax.devices()[:NDEV]), ("x",))
    jspec = jsc.ShardedCompressedSpec(JRowPartition(t, NDEV, bm=BM), bm=BM,
                                      bk=BK, mesh=mesh, axis="x")
    topo = stt.SparseTopology(t.m, t.n, t.row_offsets, t.column_indices)
    spec = ShardedCompressedSpec(RowPartition(topo, NDEV, bm=BM), bm=BM,
                                 bk=BK)
    return dict(A=A, mat=mat, jspec=jspec, spec=spec, rng=rng,
                panels=spec.stack_values(mat.values))


def _run(fn, jfn, xs, w=None):
    """Port and JAX forward and gradients of ``sum(f(xs) * w)`` (``w``:
    the output when None, i.e. ``sum(f ** 2) / 2``)."""
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = fn(*ts)
    (out * (out.detach() if w is None else torch.from_numpy(w))).sum(
        ).backward()
    jx = [jnp.asarray(x) for x in xs]
    jout = jax.jit(jfn)(*jx)

    def loss(*a):
        o = jfn(*a)
        return jnp.sum(o * (jax.lax.stop_gradient(o) if w is None
                            else jnp.asarray(w)))

    jg = jax.jit(jax.grad(loss, argnums=tuple(range(len(xs)))))(*jx)
    return (out.detach().numpy(), [t.grad.numpy() for t in ts],
            np.asarray(jout), [np.asarray(g) for g in jg])


def test_spec_equals_jax_and_values_keep_their_dtype(problem):
    spec, jspec, mat = problem["spec"], problem["jspec"], problem["mat"]
    for attr in ("mb", "kb", "m_pad_loc", "n_pad", "num_blocks", "max_bpr",
                 "max_bpc", "panel_shape"):
        assert getattr(spec, attr) == getattr(jspec, attr), attr
    nbs = [v.num_blocks for v in spec.views]
    assert min(nbs) < spec.num_blocks        # shards below the common G
    for key in _ARRAYS:
        np.testing.assert_array_equal(getattr(spec, key),
                                      getattr(jspec, key), err_msg=key)
    np.testing.assert_array_equal(problem["panels"],
                                  jspec.stack_values(mat.values))
    half = spec.stack_values(mat.values.astype(np.float16))
    assert half.dtype == np.float16                  # JAX's: float32
    np.testing.assert_array_equal(
        half, problem["panels"].astype(np.float16))


@pytest.mark.parametrize("op", ["spmm", "spmm_t", "sddmm", "softmax"])
def test_compressed_ops_match_jax(problem, op):
    spec, jspec, rng = problem["spec"], problem["jspec"], problem["rng"]
    m, n = problem["A"].shape
    panels = problem["panels"]
    w = None
    if op == "spmm":
        xs = [panels, rng.randn(n, 40).astype(np.float32)]
        fn, jfn = sharded_spmm_c, jsc.sharded_spmm_c
    elif op == "spmm_t":
        xs = [panels, rng.randn(NDEV, spec.m_pad_loc, 40).astype(
            np.float32)]
        fn, jfn = sharded_spmm_t_c, jsc.sharded_spmm_t_c
    elif op == "sddmm":
        xs = [rng.randn(NDEV, spec.m_pad_loc, 24).astype(np.float32),
              rng.randn(n, 24).astype(np.float32)]
        fn, jfn = sharded_sddmm_c, jsc.sharded_sddmm_c
    else:
        xs = [rng.randn(*panels.shape).astype(np.float32)]
        w = rng.randn(*panels.shape).astype(np.float32)
        fn, jfn = sharded_softmax_c, jsc.sharded_softmax_c
    out, grads, jout, jgrads = _run(lambda *a: fn(spec, *a),
                                    lambda *a: jfn(jspec, *a), xs, w)
    if op == "spmm":
        jout = jout[..., :40]
    _close_all(out, jout, grads, jgrads)
    if op in ("sddmm", "softmax"):
        assert np.all(out[spec.mask == 0] == 0)


def _close_all(out, jout, grads, jgrads):
    np.testing.assert_allclose(out, jout, atol=1e-4)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg[tuple(slice(0, s) for s in g.shape)],
                                   atol=1e-2)


def test_sparse_attention_sharded_c_matches_jax():
    s, hd, scale = 256, 16, 0.3
    mask = np.zeros((s, s), np.float32)
    for r in range(s):                     # banded + a dense row
        mask[r, max(0, r - 8): r + 8] = 1.0
    mask[3] = 1.0
    rng = np.random.RandomState(1)
    jtopo = st.SparseTopology.from_dense_mask(mask)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), ("x",))
    jspec = jsc.ShardedCompressedSpec(JRowPartition(jtopo, NDEV, bm=BM),
                                      bm=BM, bk=BK, mesh=mesh, axis="x")
    spec = ShardedCompressedSpec(RowPartition(
        stt.SparseTopology.from_dense_mask(mask), NDEV, bm=BM), bm=BM,
        bk=BK)
    xs = [rng.randn(NDEV, s // NDEV, hd).astype(np.float32),
          rng.randn(s, hd).astype(np.float32),
          rng.randn(s, hd).astype(np.float32)]
    out, grads, jout, jgrads = _run(
        lambda *a: sparse_attention_sharded_c(spec, *a, scale=scale),
        lambda *a: jsc.sparse_attention_sharded_c(jspec, *a, scale=scale),
        xs)
    assert out.shape == xs[0].shape
    _close_all(out, jout, grads, jgrads)


def test_sddmm_c_slots_past_a_shards_tiles_are_exact_zero(problem):
    spec, rng = problem["spec"], problem["rng"]
    lhs = torch.from_numpy(rng.randn(NDEV, spec.m_pad_loc, 8).astype(
        np.float32))
    rhs = torch.from_numpy(rng.randn(problem["A"].shape[1], 8).astype(
        np.float32))
    out = sharded_sddmm_c(spec, lhs, rhs)
    for d, v in enumerate(spec.views):
        tail = out[d, v.num_blocks:]
        assert torch.isfinite(tail).all() and not tail.any(), d


def test_compressed_ops_refuse_an_ell_spec(problem):
    ell = ShardedPanelSpec(problem["spec"].part, bm=BM, bk=BK)
    with pytest.raises(TypeError, match="ShardedCompressedSpec"):
        sharded_spmm_c(ell, torch.zeros(1), torch.zeros(1))
    with pytest.raises(ValueError, match="partition has"):
        ShardedCompressedSpec(problem["spec"].part,
                              mesh=stt.parallel.Mesh({"x": 1}))
