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


def test_unported_layouts_raise():
    mt = stt.ManyMaskTopology.from_dense_masks(driver_masks(1, 16))
    for layout in ("panel", "csr", "auto"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            SparseCoreAttention(mt, 2, layout=layout)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SparseLinear(stt.SparseTopology.from_dense_mask(np.eye(8)),
                     layout="csr")


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
