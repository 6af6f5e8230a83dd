"""The port's dynamic sparse training (``sputnik_tpu_torch.training``) against
the JAX package's (``sputnik_tpu.training``), on the CPU.

The numpy functions must give IDENTICAL arrays for the same inputs.
``rigl_update_linear`` / ``rigl_update_moe`` act on the port's modules and a
``torch.optim.Adam``; they must give the JAX update's topology, values and
remapped Adam moments exactly (compared as CSR values: the packages tile
their panels differently), and the optimizer must step on afterwards. Both
examples run their small configs with their self-checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu import training as jtr
from sputnik_tpu.models.linear import SparseLinear as JLinear
from sputnik_tpu.models.moe import SparseMoE as JMoE
from sputnik_tpu.ops import panel_api as JP
from sputnik_tpu_torch import bridge
from sputnik_tpu_torch import training as ttr
from sputnik_tpu_torch.examples import dynamic_sparse_training, \
    train_block_sparse
from sputnik_tpu_torch.models import SparseLinear, SparseMoE

TOPO_FIELDS = ("row_offsets", "column_indices", "row_ids", "valid")


def _eq(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_topology(t, j):
    assert (t.m, t.n, t.nnz, t.nnz_pad) == (j.m, j.n, j.nnz, j.nnz_pad)
    for f in TOPO_FIELDS:
        _eq(getattr(t, f), getattr(j, f), f)


def _both(mask):
    return (stt.SparseTopology.from_dense_mask(mask),
            st.SparseTopology.from_dense_mask(mask))


def test_topology_from_dense_and_remap_match():
    rng = np.random.RandomState(0)
    w = rng.randn(40, 56).astype(np.float32)
    for kw in (dict(density=0.2), dict(nnz=333, nnz_pad=400)):
        (t, tv), (j, jv) = (ttr.topology_from_dense(w, **kw),
                            jtr.topology_from_dense(w, **kw))
        _same_topology(t, j)
        _eq(tv, jv, "values")
    t2, _ = ttr.topology_from_dense(w, density=0.3)
    j2, _ = jtr.topology_from_dense(w, density=0.3)
    arr = rng.randn(t.nnz_pad).astype(np.float32)
    _eq(ttr.remap_values(t, t2, arr, fill=-1.0),
        jtr.remap_values(j, j2, arr, fill=-1.0), "remap")
    with pytest.raises(ValueError):
        ttr.topology_from_dense(w)


@pytest.mark.parametrize("kw", [dict(n_drop=37), dict(density=0.1),
                                dict(density=0.12, keep_nnz_pad=True)])
def test_magnitude_prune_matches(kw):
    rng = np.random.RandomState(1)
    t, j = _both(rng.rand(48, 40) < 0.25)
    vals = rng.randn(t.nnz_pad).astype(np.float32)
    (tn, tv), (jn, jv) = (ttr.magnitude_prune(t, vals, **kw),
                          jtr.magnitude_prune(j, vals, **kw))
    _same_topology(tn, jn)
    _eq(tv, jv, "values")


@pytest.mark.parametrize("fraction", [0.1, 0.3, 0.0])
def test_rigl_update_matches(fraction):
    rng = np.random.RandomState(2)
    t, j = _both(rng.rand(32, 48) < 0.3)
    vals = rng.randn(t.nnz_pad).astype(np.float32)
    g = rng.randn(32, 48).astype(np.float32)
    (tn, tv), (jn, jv) = (ttr.rigl_update(t, vals, g, fraction=fraction),
                          jtr.rigl_update(j, vals, g, fraction=fraction))
    _same_topology(tn, jn)
    _eq(tv, jv, "values")
    assert tn.nnz == t.nnz and tn.nnz_pad == t.nnz_pad


def test_block_functions_match():
    rng = np.random.RandomState(3)
    bm, bk = 16, 32
    t = stt.patterns.block_random_topology(64, 128, bm, bk, density=0.5,
                                           seed=3)
    j = st.patterns.block_random_topology(64, 128, bm, bk, density=0.5,
                                          seed=3)
    _eq(ttr.block_occupancy(t, bm, bk), jtr.block_occupancy(j, bm, bk))
    vals = rng.randn(t.nnz_pad).astype(np.float32)
    g = rng.randn(64, 128).astype(np.float32)
    (tn, tv), (jn, jv) = (
        ttr.block_rigl_update(t, vals, g, bm=bm, bk=bk, fraction=0.25),
        jtr.block_rigl_update(j, vals, g, bm=bm, bk=bk, fraction=0.25))
    _same_topology(tn, jn)
    _eq(tv, jv, "values")
    with pytest.raises(ValueError):
        ttr.block_rigl_update(_both(rng.rand(64, 128) < 0.3)[0], vals, g,
                              bm=bm, bk=bk)


def test_schedule_and_dense_grad_match():
    kw = dict(s_init=0.5, s_final=0.9, t_start=10, t_end=90)
    for step in (0, 10, 33, 50, 90, 200):
        assert ttr.cubic_sparsity_schedule(step, **kw) == \
            jtr.cubic_sparsity_schedule(step, **kw)
    rng = np.random.RandomState(4)
    x, gy = rng.randn(2, 5, 12), rng.randn(2, 5, 7)
    _eq(ttr.dense_linear_grad(x, gy), jtr.dense_linear_grad(x, gy))


def _adam_with_state(module, mu, nu):
    """A ``torch.optim.Adam`` that has taken one step, its moments for
    every value parameter then set to ``mu`` / ``nu`` (name -> array)."""
    opt = torch.optim.Adam(module.parameters(), lr=1e-2)
    sum(p.sum() for p in module.parameters()).backward()
    opt.step()
    for name, p in module.named_parameters():
        if name in mu:
            opt.state[p]["exp_avg"].copy_(torch.from_numpy(mu[name]))
            opt.state[p]["exp_avg_sq"].copy_(torch.from_numpy(nu[name]))
    return opt


@pytest.mark.parametrize("layout", ["csr", "panel"])
def test_rigl_update_linear_matches_jax(layout):
    """The same layer, values, moments and dense gradient through both
    packages: the JAX topology, values and moments exactly, the SAME
    parameter object updated in place, then Adam steps on."""
    rng = np.random.RandomState(5)
    m, n = 64, 96
    w0 = rng.randn(m, n).astype(np.float32)
    jt, _ = jtr.topology_from_dense(w0, density=0.25)
    tt, _ = ttr.topology_from_dense(w0, density=0.25)
    vals, mu, nu = (rng.randn(3, jt.nnz_pad).astype(np.float32)
                    * jt.valid)
    nu = np.abs(nu)
    dg = rng.randn(m, n).astype(np.float32)

    jl = JLinear(topology=jt, use_bias=True, layout=layout)

    def jlayout(a, topo, layer):
        if layout == "panel":
            spec = layer.spec()
            return jnp.asarray(JP.values_to_panel_np(topo, a, spec.bm,
                                                     spec.bk))
        return jnp.asarray(a)

    jvars = {"params": {"values": jlayout(vals, jt, jl),
                        "bias": jnp.zeros(m)}}
    new_jl, new_jvars, (jmu, jnu) = jtr.rigl_update_linear(
        jl, jvars, dg, fraction=0.2,
        opt_values=[jlayout(mu, jt, jl), jlayout(nu, jt, jl)])

    def jcsr(a):
        a = np.asarray(a)
        if layout == "panel":
            spec = new_jl.spec()
            return JP.panel_to_values_np(new_jl.topology, a, spec.bm, spec.bk)
        return a

    tiles = dict(bm=16, bk=32) if layout == "panel" else {}
    tl = SparseLinear(tt, layout=layout, **tiles)
    with torch.no_grad():
        tl.values.copy_(torch.from_numpy(tl.to_layout(vals)))
    param = tl.values
    opt = _adam_with_state(tl, {"values": tl.to_layout(mu)},
                           {"values": tl.to_layout(nu)})
    with torch.no_grad():
        tl.values.copy_(torch.from_numpy(tl.to_layout(vals)))
    assert ttr.rigl_update_linear(tl, dg, fraction=0.2, optimizer=opt) is tl
    assert tl.values is param
    _same_topology(tl.topology, new_jl.topology)
    assert tl.spec.topo is tl.topology
    _eq(tl.to_csr(tl.values), jcsr(new_jvars["params"]["values"]), "values")
    state = opt.state[tl.values]
    _eq(tl.to_csr(state["exp_avg"]), jcsr(jmu), "exp_avg")
    _eq(tl.to_csr(state["exp_avg_sq"]), jcsr(jnu), "exp_avg_sq")
    x = torch.from_numpy(rng.randn(4, n).astype(np.float32))
    for _ in range(2):
        opt.zero_grad()
        tl(x).square().mean().backward()
        opt.step()
    assert torch.isfinite(tl.values).all()
    assert torch.all(torch.from_numpy(tl.to_csr(tl.values))[
        tl.topology.nnz:] == 0)


def _in_optimizer(module, opt):
    """Every parameter of ``module`` is one of the optimizer's, by identity,
    and the optimizer holds nothing else."""
    held = [p for g in opt.param_groups for p in g["params"]]
    mine = list(module.parameters())
    return len(held) == len(mine) and all(
        any(p is q for q in held) for p in mine) and all(
        any(p is q for q in mine) for p in opt.state)


def test_rigl_update_linear_block_mode_reshapes_the_panel():
    """Whole-tile RigL that changes the panel's blocks per row block: a new
    parameter of the new shape replaces the old one in the module and the
    optimizer, Adam's state moves to it at the new shape, the values equal
    ``block_rigl_update``'s, and training goes on while a graph of the step
    before the update is still alive (it records the old shape)."""
    bm = bk = 16
    topo = stt.patterns.block_random_topology(64, 64, bm, bk, density=0.25,
                                              seed=0)
    layer = SparseLinear(topo, bm=bm, bk=bk)
    assert layer.values.shape[1] == 1                 # one tile a row block
    rng = np.random.RandomState(6)
    vals = rng.rand(topo.nnz_pad) + 1.0 + 10.0 * (topo.row_ids >= 48)
    vals = (vals * topo.valid).astype(np.float32)     # row block 3 stays
    g = np.zeros((64, 64), np.float32)
    occ = ttr.block_occupancy(topo, bm, bk)
    free = np.argwhere(occ[3] == 0)[:2, 0]
    for c in free:                                    # grow in row block 3
        g[48:, c * bk:(c + 1) * bk] = 1.0
    with torch.no_grad():
        layer.values.copy_(torch.from_numpy(layer.to_layout(vals)))
    old = layer.values
    opt = _adam_with_state(layer, {"values": layer.to_layout(vals)},
                           {"values": layer.to_layout(vals)})
    with torch.no_grad():
        layer.values.copy_(torch.from_numpy(layer.to_layout(vals)))
    loss = layer(torch.ones(2, 64)).sum()             # a graph kept alive
    loss.backward()
    want_topo, want = ttr.block_rigl_update(topo, vals, g, bm=bm, bk=bk,
                                            fraction=0.5)
    ttr.rigl_update_linear(layer, g, fraction=0.5, optimizer=opt,
                           block=(bm, bk))
    assert layer.values is not old and layer.values.shape[1] == 3
    assert _in_optimizer(layer, opt)
    _same_topology(layer.topology, want_topo)
    _eq(layer.to_csr(layer.values), want, "values")
    state = opt.state[layer.values]
    assert state["exp_avg"].shape == layer.values.shape
    _eq(layer.to_csr(state["exp_avg"]), want, "exp_avg")
    for _ in range(2):
        opt.zero_grad()
        loss = layer(torch.ones(2, 64)).sum()
        loss.backward()
        opt.step()
    assert torch.isfinite(layer.values).all()
    assert torch.all(torch.from_numpy(layer.to_csr(layer.values.grad))[
        want_topo.nnz:] == 0)


@pytest.mark.parametrize("block", [None, (16, 16)])
def test_rigl_update_moe_matches_jax(block):
    rng = np.random.RandomState(7)
    h, f, E = 32, 48, 3
    if block is None:
        m_in = (rng.rand(f, h) < 0.4).astype(np.float32)
        m_out = (rng.rand(h, f) < 0.4).astype(np.float32)
    else:
        m_in = st.patterns.block_random_mask(f, h, *block, density=0.5,
                                             seed=1)
        m_out = st.patterns.block_random_mask(h, f, *block, density=0.5,
                                              seed=2)
    x = rng.randn(2, 8, h).astype(np.float32)
    jm = JMoE(topo_in=st.SparseTopology.from_dense_mask(m_in),
              topo_out=st.SparseTopology.from_dense_mask(m_out),
              num_experts=E, top_k=2)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0), x))
    mu = {k: np.abs(np.asarray(v)) + 0.5
          for k, v in params["params"].items() if k.startswith("w_")}
    gd_in = rng.randn(E, f, h).astype(np.float32)
    gd_out = rng.randn(h, f).astype(np.float32)
    new_jm, new_jvars, (jmu,) = jtr.rigl_update_moe(
        jm, params, gd_in, gd_out, fraction=0.25, opt_values=[mu],
        block=block)

    tm = SparseMoE(stt.SparseTopology.from_dense_mask(m_in),
                   stt.SparseTopology.from_dense_mask(m_out), E, top_k=2,
                   bank_tiles=(16, 16))
    tm.load_state_dict(bridge.moe_state_dict(params, tm))
    ported_mu = bridge.moe_state_dict({"router": params["params"]["router"],
                                       **mu}, tm)
    opt = _adam_with_state(tm, {k: v.numpy() for k, v in ported_mu.items()
                                if k.startswith("w_")},
                           {k: v.numpy() for k, v in ported_mu.items()
                            if k.startswith("w_")})
    tm.load_state_dict(bridge.moe_state_dict(params, tm))
    shapes = (tm.w_in_values.shape, tm.w_out_values.shape)
    assert ttr.rigl_update_moe(tm, gd_in, gd_out, fraction=0.25,
                               optimizer=opt, block=block) is tm
    assert _in_optimizer(tm, opt)
    if block is None:             # element-random: the bank keeps its shape
        assert (tm.w_in_values.shape, tm.w_out_values.shape) == shapes
    for which in ("in", "out"):
        _same_topology(getattr(tm, f"topo_{which}"),
                       getattr(new_jm, f"topo_{which}"))
        name = f"w_{which}_values"
        _eq(tm.flat_values(getattr(tm, name), which),
            new_jm.flat_values(new_jvars["params"][name], which), name)
        _eq(tm.flat_values(opt.state[getattr(tm, name)]["exp_avg"], which),
            new_jm.flat_values(jmu[name], which), f"{name} exp_avg")
        assert getattr(tm, f"spec_{which}").topologies == [
            getattr(tm, f"topo_{which}")]
    y = tm(torch.from_numpy(x))
    (y.sum() + tm.aux_loss).backward()
    opt.step()
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("layout", ["csr", "panel"])
def test_dynamic_sparse_training_example_small(layout):
    out = dynamic_sparse_training.main(["--small", "--device", "cpu",
                                        "--layout", layout])
    assert out["rigl"] < out["static"]


def test_train_block_sparse_example_small():
    out = train_block_sparse.main(["--small", "--device", "cpu"])
    assert out["evolved"] < out["frozen"]
