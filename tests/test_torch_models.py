"""Modules of the PyTorch port against the JAX package's flax modules, with
the flax weights carried across by ``sputnik_tpu_torch.bridge``.

CPU only: the port runs its kernels' plain versions; the JAX side runs its
default CPU path (the unfused oracle) and, where noted, its Pallas kernels
in interpret mode. Tolerance atol = rtol = 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu.models.attention import SparseAttention as JAttention
from sputnik_tpu.models.linear import SparseLinear as JLinear
from sputnik_tpu.models.transformer import SparseTransformer as JTransformer
from sputnik_tpu.topology import SparseTopology as JTopology
from sputnik_tpu_torch import bridge
from sputnik_tpu_torch.models import (SparseAttention, SparseCoreAttention,
                                      SparseLinear, SparseTransformer)
from sputnik_tpu_torch.patterns import driver_masks

TOL = dict(atol=1e-4, rtol=1e-4)


def _randomise_biases(params, seed):
    """flax inits biases to 0; give them values so the test sees them."""
    rng = np.random.RandomState(seed)

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) or hasattr(v, "items")
                    else (rng.randn(*np.shape(v)).astype(np.float32) * 0.1
                          if k == "bias" else np.asarray(v, np.float32)))
                for k, v in node.items()}

    return walk(params)


@pytest.mark.parametrize("fuse_relu", [False, True])
def test_sparse_linear_matches_flax(fuse_relu):
    rng = np.random.RandomState(0)
    mask = (rng.rand(48, 40) < 0.3).astype(np.float32)
    mask[5] = 0.0
    x = rng.randn(3, 5, 40).astype(np.float32)
    jl = JLinear(topology=JTopology.from_dense_mask(mask), fuse_relu=fuse_relu)
    params = _randomise_biases(jl.init(jax.random.PRNGKey(0), x), 1)
    ref = np.asarray(jl.apply(params, x))

    tl = SparseLinear(stt.SparseTopology.from_dense_mask(mask),
                      fuse_relu=fuse_relu)
    tl.load_state_dict(bridge.sparse_linear_state_dict(params, tl))
    got = tl(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (3, 5, 48)
    np.testing.assert_allclose(got, ref, **TOL)
    # the dense weight seen by both packages is the same
    np.testing.assert_array_equal(
        tl.unpack_dense(tl.values),
        jl.unpack_dense(params["params"]["values"]))
    np.testing.assert_array_equal(
        tl.pack_dense(tl.unpack_dense(tl.values)), tl.values.detach().numpy())


@pytest.mark.parametrize("jax_layout", ["csr", "panel"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("fuse_relu", [False, True])
def test_csr_sparse_linear_matches_flax(fuse_relu, backend, jax_layout):
    """The csr layer (flat values through ``left_spmm`` / ``spmm_bias_relu``,
    oracle and panel routes) against flax ``SparseLinear(layout="csr")``;
    flax weights of either layout cross through ``bridge``; forward and the
    values / bias / input gradients at atol = rtol = 1e-4."""
    rng = np.random.RandomState(3)
    mask = (rng.rand(48, 40) < 0.3).astype(np.float32)
    mask[7] = 0.0
    x = rng.randn(3, 5, 40).astype(np.float32)
    jt = JTopology.from_dense_mask(mask)
    jcsr = JLinear(topology=jt, fuse_relu=fuse_relu, layout="csr")
    params = _randomise_biases(jcsr.init(jax.random.PRNGKey(2), x), 4)
    if jax_layout == "panel":
        jpan = JLinear(topology=jt, fuse_relu=fuse_relu)
        w = jcsr.unpack_dense(params["params"]["values"])
        src = {"params": dict(params["params"], values=jpan.pack_dense(w))}
    else:
        src = params
    ref, vjp = jax.vjp(lambda p, xx: jcsr.apply(p, xx), params, x)
    g = rng.randn(*ref.shape).astype(np.float32)
    jg_params, jg_x = vjp(g)

    tl = SparseLinear(stt.SparseTopology.from_dense_mask(mask),
                      fuse_relu=fuse_relu, layout="csr")
    tl.load_state_dict(bridge.sparse_linear_state_dict(src, tl))
    xt = torch.from_numpy(x).requires_grad_()
    stt.set_backend(backend)
    try:
        got = tl(xt)
        got.backward(torch.from_numpy(g))
    finally:
        stt.set_backend("auto")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tl.values.grad.numpy(),
                               np.asarray(jg_params["params"]["values"]),
                               **TOL)
    np.testing.assert_allclose(tl.bias.grad.numpy(),
                               np.asarray(jg_params["params"]["bias"]), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), **TOL)
    np.testing.assert_array_equal(
        tl.unpack_dense(tl.values),
        jcsr.unpack_dense(params["params"]["values"]))
    np.testing.assert_array_equal(
        tl.pack_dense(tl.unpack_dense(tl.values)), tl.values.detach().numpy())


def test_csr_and_panel_layers_agree():
    """One weight in both layouts gives one output (the panel kernels'
    plain versions behind both), and the csr init is Kaiming-uniform over
    the nonzeros with 0 at padding."""
    rng = np.random.RandomState(5)
    topo = stt.SparseTopology.from_dense_mask(rng.rand(40, 24) < 0.25)
    csr = SparseLinear(topo, layout="csr",
                       generator=torch.Generator().manual_seed(1))
    pan = SparseLinear(topo, bm=16, bk=8)
    with torch.no_grad():
        pan.values.copy_(torch.from_numpy(pan.pack_dense(
            csr.unpack_dense(csr.values))))
        pan.bias.normal_()
        csr.bias.copy_(pan.bias)
    x = torch.from_numpy(rng.randn(2, 6, 24).astype(np.float32))
    torch.testing.assert_close(csr(x), pan(x), atol=1e-5, rtol=1e-5)
    v = csr.values.detach()
    assert v.shape == (topo.nnz_pad,) and torch.all(v[topo.nnz:] == 0)
    bound = np.sqrt(3.0 / (topo.nnz / topo.m))
    assert v.abs().max() <= bound and v[: topo.nnz].std() > 0.3 * bound


def test_csr_layer_runs_the_flat_spec():
    """A csr layer's spec is the one its flat forward runs (one per
    topology, kept by the topology), also after a topology swap; tiles
    other than the flat op set's raise."""
    from sputnik_tpu_torch.ops import dispatch

    rng = np.random.RandomState(6)
    topo = stt.SparseTopology.from_dense_mask(rng.rand(40, 24) < 0.25)
    csr = SparseLinear(topo, layout="csr")
    assert csr.spec is dispatch.flat_spec(topo)
    assert csr.spec is dispatch.flat_spec(topo)
    assert (csr.spec.bm, csr.spec.bk) == stt.ops.panel_api.DEFAULT_BLOCK
    other = stt.SparseTopology.from_dense_mask(rng.rand(40, 24) < 0.25)
    csr.set_topology(other)
    assert csr.topology is other and csr.spec is dispatch.flat_spec(other)
    pan = SparseLinear(topo, bm=16, bk=8)
    pan.set_topology(other)
    assert (pan.spec.topo, pan.spec.bm, pan.spec.bk) == (other, 16, 8)
    with pytest.raises(ValueError, match="tiles"):
        SparseLinear(topo, layout="csr", bm=16, bk=8)


def test_sparse_attention_matches_flax():
    rng = np.random.RandomState(1)
    s, e, heads = 40, 32, 2
    mask = (rng.rand(s, s) < 0.3).astype(np.float32)
    mask[11] = 0.0
    x = rng.randn(2, s, e).astype(np.float32)
    ja = JAttention(num_heads=heads, embed_dim=e,
                    score_topology=JTopology.from_dense_mask(mask))
    params = _randomise_biases(ja.init(jax.random.PRNGKey(1), x), 2)
    ref = np.asarray(ja.apply(params, x))

    ta = SparseAttention(heads, e, stt.SparseTopology.from_dense_mask(mask))
    ta.load_state_dict(bridge.sparse_attention_state_dict(params, ta))
    with torch.no_grad():
        got = ta(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def _entry_models(num_kv_heads=None, layout="flash"):
    """``__graft_entry__.entry()``'s config: b=2, s=128, h=128, 4 heads,
    2 layers, ffn 256, residual + LayerNorm + gelu, causal masks with one
    fully-masked row."""
    cfg = dict(num_layers=2, hidden_size=128, num_heads=4,
               ffn_hidden_size=256, num_kv_heads=num_kv_heads,
               use_residual=True, use_layernorm=True, activation="gelu",
               attention_layout=layout)
    masks = driver_masks(2, 128)
    x = np.random.RandomState(0).randn(2, 128, 128).astype(np.float32)
    jm = JTransformer.from_masks(masks, **cfg)
    params = _randomise_biases(jm.init(jax.random.PRNGKey(0), x), 3)
    tm = SparseTransformer.from_masks(masks, **cfg)
    tm.load_state_dict(bridge.transformer_state_dict(params))
    return jm, params, tm, x


@pytest.mark.parametrize("num_kv_heads", [None, 2])
@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_transformer_matches_flax_at_entry_config(backend, num_kv_heads):
    jm, params, tm, x = _entry_models(num_kv_heads)
    st.set_backend(backend)
    try:
        ref = np.asarray(jm.apply(params, x))
    finally:
        st.set_backend("auto")
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, **TOL)


def test_transformer_xla_layout_matches_flax():
    jm, params, tm, x = _entry_models(layout="xla")
    ref = np.asarray(jm.apply(params, x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("num_kv_heads", [None, 2])
@pytest.mark.parametrize("layout", ["panel", "csr"])
def test_transformer_panel_and_csr_layouts_match_flax(layout, num_kv_heads):
    """The batched panel chain (distinct per-mask metadata; GQA by K/V
    expansion) and the flat many-mask chain against flax's same layout."""
    jm, params, tm, x = _entry_models(num_kv_heads, layout)
    ref = np.asarray(jax.jit(jm.apply)(params, x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, **TOL)


def test_unported_layouts_raise():
    mt = stt.ManyMaskTopology.from_dense_masks(driver_masks(1, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        SparseCoreAttention(mt, 2, layout="auto")
    with pytest.raises(ValueError, match="unknown layout"):
        SparseCoreAttention(mt, 2, layout="dense")
    with pytest.raises(ValueError, match="unknown layout"):
        SparseLinear(stt.SparseTopology.from_dense_mask(np.eye(8)),
                     layout="dense")


def test_generator_makes_init_reproducible():
    masks = driver_masks(1, 64)
    kw = dict(num_layers=1, hidden_size=32, num_heads=2, ffn_hidden_size=64)
    a = SparseTransformer.from_masks(
        masks, generator=torch.Generator().manual_seed(5), **kw)
    b = SparseTransformer.from_masks(
        masks, generator=torch.Generator().manual_seed(5), **kw)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
