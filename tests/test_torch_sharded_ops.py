"""The replicated-operand sharded panel ops of the PyTorch port against the
JAX package, on the CPU.

  * ``sharded_spmm``, ``sharded_spmm_t``, ``sharded_sddmm``,
    ``sharded_softmax`` and ``sparse_attention_sharded`` (at a scale other
    than the default): forward and gradients against JAX's on an 8-device
    CPU mesh, with the port's natural widths (JAX pads ``q`` / ``d`` to
    128 lanes) and operands shorter than ``m_pad_loc`` rows (JAX pads
    them; the port's kernels read the missing rows as zeros);
  * bf16 operands promote and compute in float32 (C1's boundary);
  * the ops' ``ValueError``s, and ``stt.parallel`` exports every name of
    JAX's ``parallel`` but the multi-card layer's (``ROADMAP.md`` A9c).

The JAX tests' small shapes (``tests/test_parallel.py``): a 320 x 256
d=0.3 matrix, balanced rows, bm 8, bk 128. Tolerances: atol 1e-4 on
outputs, 1e-2 on gradients (f32 on both sides, sums in another order).
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
from sputnik_tpu.parallel import sharded_ops as jso
from sputnik_tpu_torch.parallel import (RowPartition, ShardedPanelSpec,
                                        sharded_sddmm, sharded_softmax,
                                        sharded_spmm, sharded_spmm_halo,
                                        sharded_spmm_t,
                                        sparse_attention_sharded)

NDEV, BM, BK = 8, 8, 128


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small products, and under
    the suite's parallel workers more threads a worker oversubscribe the
    cores (each test took up to 100x its time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _topo(mat):
    t = mat.topology
    return stt.SparseTopology(t.m, t.n, t.row_offsets, t.column_indices)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(0)
    m, n = 320, 256
    A = ((rng.rand(m, n) < 0.3) * rng.randn(m, n)).astype(np.float32)
    mat = st.SparseMatrix(A)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), ("x",))
    jspec = jso.ShardedPanelSpec(JRowPartition(mat.topology, NDEV, bm=BM),
                                 bm=BM, bk=BK, mesh=mesh, axis="x")
    spec = ShardedPanelSpec(RowPartition(_topo(mat), NDEV, bm=BM), bm=BM,
                            bk=BK)
    return dict(A=A, mat=mat, jspec=jspec, spec=spec, rng=rng,
                panels=spec.stack_values(mat.values))


def _grads(fn, *xs):
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = fn(*ts)
    out.square().sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jgrads(fn, *xs):
    out = jax.jit(fn)(*map(jnp.asarray, xs))
    gs = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                          argnums=tuple(range(len(xs)))))(
        *map(jnp.asarray, xs))
    return np.asarray(out), [np.asarray(g) for g in gs]


def _close(got, want, atol):
    np.testing.assert_allclose(got, want, atol=atol)


def test_sharded_spmm_matches_jax(problem):
    spec, jspec, rng = problem["spec"], problem["jspec"], problem["rng"]
    q = 40
    dense = rng.randn(problem["A"].shape[1], q).astype(np.float32)
    out, (gp, gd) = _grads(lambda p, d: sharded_spmm(spec, p, d),
                           problem["panels"], dense)
    jout, (jgp, jgd) = _jgrads(lambda p, d: jso.sharded_spmm(jspec, p, d),
                               problem["panels"], dense)
    assert out.shape == (NDEV, spec.m_pad_loc, q) and jout.shape[-1] == 128
    _close(out, jout[..., :q], 1e-4)
    got = spec.part.unpermute_rows(torch.from_numpy(out.reshape(-1, q)))
    _close(got.numpy(), problem["A"] @ dense, 1e-3)
    _close(gp, jgp, 1e-2)
    _close(gd, jgd, 1e-2)


def test_sharded_spmm_t_short_natural_width_g_matches_jax(problem):
    """``g_sh`` with fewer rows than ``m_pad_loc`` and q = 40: whole
    results, equal to JAX's (which pads both)."""
    spec, jspec, rng = problem["spec"], problem["jspec"], problem["rng"]
    g = rng.randn(NDEV, spec.m_pad_loc - BM, 40).astype(np.float32)
    out, (gp, gg) = _grads(lambda p, x: sharded_spmm_t(spec, p, x),
                           problem["panels"], g)
    jout, (jgp, jgg) = _jgrads(lambda p, x: jso.sharded_spmm_t(jspec, p, x),
                               problem["panels"], g)
    assert out.shape == (spec.n_pad, 40) and jout.shape == out.shape
    _close(out, jout, 1e-4)
    _close(gp, jgp, 1e-2)
    _close(gg, jgg, 1e-2)


def test_sharded_sddmm_short_lhs_matches_jax(problem):
    spec, jspec, rng = problem["spec"], problem["jspec"], problem["rng"]
    lhs = rng.randn(NDEV, spec.m_pad_loc - 3, 24).astype(np.float32)
    rhs = rng.randn(problem["A"].shape[1], 24).astype(np.float32)
    out, (gl, gr) = _grads(lambda a, b: sharded_sddmm(spec, a, b), lhs, rhs)
    jout, (jgl, jgr) = _jgrads(lambda a, b: jso.sharded_sddmm(jspec, a, b),
                               lhs, rhs)
    _close(out, jout, 1e-4)
    assert np.all(out[spec.mask == 0] == 0)
    _close(gl, jgl[:, : lhs.shape[1], :24], 1e-2)
    _close(gr, jgr, 1e-2)


def test_sharded_softmax_matches_jax(problem):
    spec, jspec, rng = problem["spec"], problem["jspec"], problem["rng"]
    x = rng.randn(*problem["panels"].shape).astype(np.float32)
    w = rng.randn(*x.shape).astype(np.float32)   # cotangent at every slot
    t = torch.from_numpy(x).requires_grad_()
    p = sharded_softmax(spec, t)
    (p * torch.from_numpy(w)).sum().backward()
    jp = jax.jit(lambda a: jso.sharded_softmax(jspec, a))(jnp.asarray(x))
    jg = jax.jit(jax.grad(lambda a: jnp.sum(
        jso.sharded_softmax(jspec, a) * jnp.asarray(w))))(jnp.asarray(x))
    _close(p.detach().numpy(), np.asarray(jp), 1e-4)
    _close(t.grad.numpy(), np.asarray(jg), 1e-4)
    assert np.all(p.detach().numpy()[spec.mask == 0] == 0)


def test_sparse_attention_sharded_matches_jax():
    s, hd, scale = 256, 24, 0.3
    mask = np.tril(np.ones((s, s), np.float32))
    mask[5] = 0.0                               # a fully masked row
    jtopo = st.SparseTopology.from_dense_mask(mask)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), ("x",))
    jspec = jso.ShardedPanelSpec(
        JRowPartition(jtopo, NDEV, bm=BM, balance=False), bm=BM, bk=BK,
        mesh=mesh, axis="x")
    spec = ShardedPanelSpec(RowPartition(
        stt.SparseTopology.from_dense_mask(mask), NDEV, bm=BM,
        balance=False), bm=BM, bk=BK)
    rng = np.random.RandomState(4)
    q = rng.randn(NDEV, s // NDEV, hd).astype(np.float32)
    k, v = (rng.randn(s, hd).astype(np.float32) for _ in range(2))
    out, grads = _grads(lambda a, b, c: sparse_attention_sharded(
        spec, a, b, c, scale=scale), q, k, v)
    jout, jgrads = _jgrads(lambda a, b, c: jso.sparse_attention_sharded(
        jspec, a, b, c, scale=scale), q, k, v)
    assert out.shape == q.shape
    _close(out, jout, 1e-4)
    for g, jg in zip(grads, jgrads):
        _close(g, jg, 1e-2)
    sc = np.where(mask != 0, q.reshape(s, hd) @ k.T * scale, -1e30)
    e = np.exp(sc - sc.max(-1, keepdims=True)) * (mask != 0)
    ref = e / np.maximum(e.sum(-1, keepdims=True), 1e-30) @ v
    _close(out.reshape(s, hd), ref, 1e-4)


def test_bf16_operands_promote_and_compute_in_f32(problem):
    spec, rng = problem["spec"], problem["rng"]
    panels = torch.from_numpy(problem["panels"]).bfloat16()
    dense = torch.from_numpy(rng.randn(problem["A"].shape[1], 16).astype(
        np.float32)).bfloat16()
    out = sharded_spmm(spec, panels, dense)
    assert out.dtype == torch.bfloat16
    want = sharded_spmm(spec, panels.float(), dense.float())
    _close(out.float().numpy(), want.bfloat16().float().numpy(), 0)
    mixed = sharded_spmm(spec, panels, dense.float())
    assert mixed.dtype == torch.float32
    _close(mixed.numpy(), want.numpy(), 0)


def test_sharded_ops_validation(problem):
    spec = problem["spec"]
    panels = torch.from_numpy(problem["panels"])
    n = problem["A"].shape[1]
    with pytest.raises(ValueError, match="panels"):
        sharded_spmm(spec, panels[1:], torch.zeros(n, 4))
    with pytest.raises(ValueError, match="dense"):
        sharded_spmm(spec, panels, torch.zeros(n - 1, 4))
    with pytest.raises(ValueError, match="g_sh"):
        sharded_spmm_t(spec, panels, torch.zeros(NDEV, spec.m_pad_loc + 1,
                                                 4))
    with pytest.raises(ValueError, match="lhs_sh"):
        sharded_sddmm(spec, torch.zeros(NDEV - 1, 8, 4), torch.zeros(n, 4))
    with pytest.raises(ValueError, match="depth"):
        sharded_sddmm(spec, torch.zeros(NDEV, 8, 4), torch.zeros(n, 5))
    with pytest.raises(ValueError, match="panels"):
        sharded_softmax(spec, panels[:, :1])
    comp = stt.parallel.ShardedCompressedSpec(spec.part, bm=BM, bk=BK)
    with pytest.raises(ValueError, match="ELL"):
        sharded_spmm_halo(comp, torch.zeros((NDEV,) + comp.panel_shape),
                          torch.zeros(NDEV, n // NDEV, 4))


def test_parallel_exports_jax_names_but_the_multi_card_layer():
    import sputnik_tpu.parallel as jp

    a9c = {"TPDecoder", "PagedTPDecoder", "TPLMServer"}
    missing = set(jp.__all__) - a9c - set(stt.parallel.__all__)
    assert not missing, missing
    for name in stt.parallel.__all__:
        assert hasattr(stt.parallel, name), name
