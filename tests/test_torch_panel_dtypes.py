"""bf16 and mixed-dtype panel ops of the PyTorch port against the JAX
package, on the CPU.

JAX's panel ops promote a mixed panel / dense (or lhs / rhs) pair
(``sputnik_tpu/ops/panel_api.py:_match_dtypes``), return the promoted dtype
on its CPU route and hand every cotangent back in its primal's dtype. The
port computes in float32 (its kernels' type) and casts at the op's
boundary, so dtypes equal JAX's and values agree to bf16 rounding
(JAX sums bf16 x bf16 in bf16): rtol 2e-2 and atol 2e-2 x max(1,
max|ref|), against JAX on the same bf16-rounded inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu.models.linear import SparseLinear as JLinear
from sputnik_tpu.ops import panel_api as JP
from sputnik_tpu.topology import SparseTopology as JTopology
from sputnik_tpu_torch import bridge
from sputnik_tpu_torch.models import SparseLinear
from sputnik_tpu_torch.ops import panel_api as P

PAIRS = [("bf16", "f32"), ("f32", "bf16"), ("bf16", "bf16")]
_T = {"bf16": torch.bfloat16, "f32": torch.float32}
_J = {"bf16": jnp.bfloat16, "f32": jnp.float32}


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=2e-2, atol=2e-2 * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(0)
    A = ((rng.rand(48, 40) < 0.3) * rng.randn(48, 40)).astype(np.float32)
    A[5] = 0.0
    mat = st.SparseMatrix(A)
    # bf16-exact host values, so both packages start from the same numbers
    r = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    return dict(mat=mat, topo=stt.SparseTopology(
        48, 40, mat.topology.row_offsets, mat.topology.column_indices),
        values=r(mat.values), dense=r(rng.randn(40, 8)),
        lhs=r(rng.randn(48, 8)), g=r(rng.randn(48, 8)))


def _jax_op(op, spec, a, b):
    if op == "spmm":
        return JP.spmm(spec, a, b)
    if op == "spmm_t":
        return JP.spmm_t(spec, a, b)
    return JP.sddmm(spec, a, b)


def _port_op(op, spec, a, b):
    return getattr(P, op)(spec, a, b)


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}x{p[1]}")
@pytest.mark.parametrize("op", ["spmm", "spmm_t", "sddmm"])
def test_mixed_dtype_panel_ops_match_jax(problem, op, pair, compressed):
    mat, topo = problem["mat"], problem["topo"]
    jspec = JP.PanelSpec(mat.topology, 16, 16, compressed=compressed)
    spec = P.PanelSpec(topo, 16, 16, compressed=compressed)
    jpanel = JP.values_to_panel_np(mat.topology, problem["values"], 16, 16,
                                   compressed=compressed)
    tpanel = P.values_to_panel_np(topo, problem["values"], 16, 16,
                                  compressed=compressed)
    if op == "sddmm":
        ja = ta = problem["lhs"]
        jb = tb = problem["dense"]
    else:
        ja, ta = jpanel, tpanel
        jb = tb = problem["g"] if op == "spmm_t" else problem["dense"]
    a_dt, b_dt = pair
    ja_, jb_ = jnp.asarray(ja, _J[a_dt]), jnp.asarray(jb, _J[b_dt])
    ref = _jax_op(op, jspec, ja_, jb_)
    ga, gb = jax.grad(lambda x, y: jnp.sum(
        _jax_op(op, jspec, x, y).astype(jnp.float32) ** 2),
        argnums=(0, 1))(ja_, jb_)

    ta_ = torch.tensor(ta).to(_T[a_dt]).requires_grad_()
    tb_ = torch.tensor(tb).to(_T[b_dt]).requires_grad_()
    out = _port_op(op, spec, ta_, tb_)
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    out.float().square().sum().backward()
    assert ta_.grad.dtype == ta_.dtype and tb_.grad.dtype == tb_.dtype
    assert str(ga.dtype) == str(ta_.grad.dtype).split(".")[-1]
    assert str(gb.dtype) == str(tb_.grad.dtype).split(".")[-1]
    if op == "sddmm":      # panels of the same tiles: compare CSR values
        got = P.panel_to_values_np(topo, out.detach().float().numpy(), 16,
                                   16, compressed=compressed)
        want = JP.panel_to_values_np(mat.topology,
                                     np.asarray(ref, np.float32), 16, 16,
                                     compressed=compressed)
        _close(ta_.grad.float().numpy(), ga)
    else:
        got, want = out.detach().float().numpy(), np.asarray(ref, np.float32)
        _close(P.panel_to_values_np(topo, ta_.grad.float().numpy(), 16, 16,
                                    compressed=compressed),
               JP.panel_to_values_np(mat.topology,
                                     np.asarray(ga, np.float32), 16, 16,
                                     compressed=compressed))
    _close(got, want)
    _close(tb_.grad.float().numpy(), gb)


@pytest.mark.parametrize("compressed", [False, True])
def test_bf16_softmax_keeps_the_panel_dtype(problem, compressed):
    mat, topo = problem["mat"], problem["topo"]
    jspec = JP.PanelSpec(mat.topology, 16, 16, compressed=compressed)
    spec = P.PanelSpec(topo, 16, 16, compressed=compressed)
    panel = P.values_to_panel_np(topo, problem["values"], 16, 16,
                                 compressed=compressed)
    ref = JP.sparse_softmax(jspec, jnp.asarray(
        JP.values_to_panel_np(mat.topology, problem["values"], 16, 16,
                              compressed=compressed), jnp.bfloat16))
    x = torch.tensor(panel).bfloat16().requires_grad_()
    out = P.sparse_softmax(spec, x)
    assert out.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
    out.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    _close(P.panel_to_values_np(topo, out.detach().float().numpy(), 16, 16,
                                compressed=compressed),
           JP.panel_to_values_np(mat.topology, np.asarray(ref, np.float32),
                                 16, 16, compressed=compressed))


@pytest.mark.parametrize("fuse_relu", [False, True])
def test_bf16_sparse_linear_on_f32_input_matches_flax(fuse_relu):
    """``SparseLinear(dtype=torch.bfloat16)`` on an f32 input returns f32,
    as flax's ``param_dtype=jnp.bfloat16`` does, with the same values."""
    rng = np.random.RandomState(3)
    mask = (rng.rand(48, 40) < 0.3).astype(np.float32)
    x = rng.randn(3, 5, 40).astype(np.float32)
    jl = JLinear(topology=JTopology.from_dense_mask(mask),
                 fuse_relu=fuse_relu, param_dtype=jnp.bfloat16)
    params = jl.init(jax.random.PRNGKey(0), x)
    params = jax.tree_util.tree_map(
        lambda p: (p + 0.1 * jnp.asarray(rng.randn(*p.shape), p.dtype)
                   if p.ndim == 1 else p), params)      # non-zero biases
    ref = jl.apply(params, x)
    assert ref.dtype == jnp.float32

    tl = SparseLinear(stt.SparseTopology.from_dense_mask(mask),
                      fuse_relu=fuse_relu, dtype=torch.bfloat16)
    tl.load_state_dict(bridge.sparse_linear_state_dict(params, tl))
    assert tl.values.dtype == torch.bfloat16
    xt = torch.from_numpy(x).requires_grad_()
    got = tl(xt)
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), ref)
    got.sum().backward()
    assert tl.values.grad.dtype == torch.bfloat16
    assert xt.grad.dtype == torch.float32
