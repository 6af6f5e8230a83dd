"""bf16 activations through the port's ``SparseTransformer`` and
``SparseMoE`` against the JAX package's flax modules on the CPU, with the
flax weights carried across by ``sputnik_tpu_torch.bridge``.

Flax's ``nn.Dense`` and ``nn.LayerNorm`` promote a bf16 input against their
f32 parameters, so JAX's modules take a bf16 ``x`` and return f32; its
``SparseMoE`` casts the expert bank's output to the input's dtype before the
combine. The port does the same. Tolerances are C1's (the panel ops' bf16
rule): rtol 2e-2 and atol 2e-2 x max(1, max|ref|), forward and gradients,
against JAX on the same bf16 inputs. The transformer's forward is also held
within 1e-4 x max(1, max|ref|): after flax's promotion every product is
f32, so only the LayerNorm's rule can move it, and a LayerNorm that rounds
its statistics to bf16 (JAX's serving function) lands ~2e-3 away.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu.models.moe import SparseMoE as JMoE
from sputnik_tpu.models.transformer import SparseTransformer as JTransformer
from sputnik_tpu_torch import bridge
from sputnik_tpu_torch.models import SparseMoE, SparseTransformer
from sputnik_tpu_torch.patterns import driver_masks


def _close(got, want, what, tol=2e-2):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=tol,
        atol=tol * max(1.0, float(np.abs(want).max())), err_msg=what)


def _bf16(rng, *shape):
    """A bf16 array and its exact f32 values, for both packages."""
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()
    return x, jnp.asarray(x.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("layout", ["flash", "xla", "panel", "csr", "auto"])
def test_transformer_bf16_input_matches_flax(layout):
    """1 layer, h 64, 2 heads, residual + LayerNorm + gelu: a bf16 ``x``
    returns f32; the output, ``x``'s gradient (bf16, its primal's dtype)
    and every parameter's gradient match flax's."""
    cfg = dict(num_layers=1, hidden_size=64, num_heads=2, ffn_hidden_size=96,
               use_residual=True, use_layernorm=True, activation="gelu",
               attention_layout=layout)
    masks = driver_masks(2, 64)
    rng = np.random.RandomState(5)
    tx, jx = _bf16(rng, 2, 64, 64)
    cot = rng.randn(2, 64, 64).astype(np.float32)
    jm = JTransformer.from_masks(masks, **cfg)
    params = jm.init(jax.random.PRNGKey(1), jx.astype(jnp.float32))

    def loss(p, x):
        y = jm.apply(p, x)
        return jnp.sum(y * cot), y

    (_, ref), (g_p, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jx)
    assert ref.dtype == jnp.float32

    tm = SparseTransformer.from_masks(masks, **cfg)
    tm.load_state_dict(bridge.transformer_state_dict(params))
    tx.requires_grad_()
    y = tm(tx)
    assert y.dtype == torch.float32
    (y * torch.from_numpy(cot)).sum().backward()
    _close(y.detach().numpy(), ref, "output", tol=1e-4)
    assert tx.grad.dtype == torch.bfloat16
    _close(tx.grad.float().numpy(), np.asarray(g_x, np.float32), "x grad")
    grads = dict(tm.named_parameters())
    ref_g = bridge.transformer_state_dict(g_p)
    assert set(ref_g) == set(grads)
    for k, want in ref_g.items():
        _close(grads[k].grad.numpy(), want.numpy(), k)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_bf16_input_matches_flax(top_k):
    """A top-1 / top-2 ``SparseMoE`` on bf16: f32 out, within C1's
    tolerance of flax's."""
    rng = np.random.RandomState(top_k + 2)
    m_in = (rng.rand(48, 32) < 0.4).astype(np.float32)
    m_out = (rng.rand(32, 48) < 0.4).astype(np.float32)
    tx, jx = _bf16(rng, 2, 8, 32)
    jm = JMoE(topo_in=st.SparseTopology.from_dense_mask(m_in),
              topo_out=st.SparseTopology.from_dense_mask(m_out),
              num_experts=4, top_k=top_k)
    params = jm.init(jax.random.PRNGKey(0), jx.astype(jnp.float32))
    ref = jax.jit(jm.apply)(params, jx)
    assert ref.dtype == jnp.float32
    tm = SparseMoE(stt.SparseTopology.from_dense_mask(m_in),
                   stt.SparseTopology.from_dense_mask(m_out), 4, top_k=top_k,
                   bank_tiles=(16, 32))
    tm.load_state_dict(bridge.moe_state_dict(params, tm))
    y = tm(tx)
    assert y.dtype == torch.float32
    _close(y.detach().numpy(), ref, "output")


def test_moe_bf16_routing_exact_past_256():
    """Twin of the JAX suite's test: bf16 inputs with capacity > 256 (one
    expert, 600 tokens, C = 750). The routing positions must stay exact (a
    bf16 cumsum rounds 257 to 258, so two tokens would share a slot and
    their inputs sum): the bf16 forward within a loose bound of the f32
    forward, which rounding noise meets and a collision's O(1) error does
    not."""
    rng = np.random.RandomState(7)
    m_in = (rng.rand(48, 32) < 0.4).astype(np.float32)
    m_out = (rng.rand(32, 48) < 0.4).astype(np.float32)
    moe = SparseMoE(stt.SparseTopology.from_dense_mask(m_in),
                    stt.SparseTopology.from_dense_mask(m_out), 1,
                    capacity_factor=1.25,
                    generator=torch.Generator().manual_seed(0))
    x32 = torch.from_numpy(rng.randn(1, 600, 32).astype(np.float32))
    with torch.no_grad():
        y32 = moe(x32)
        y16 = moe(x32.bfloat16())
    assert y16.dtype == torch.float32
    d = (y16 - y32).abs() / (y32.abs().max() + 1e-6)
    assert float(d.max()) < 0.15, float(d.max())
