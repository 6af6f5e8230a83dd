"""Training through the PyTorch port on the CPU (autograd Functions over the
kernels' plain versions) against the JAX package's flax modules, with the
flax parameters carried across by ``sputnik_tpu_torch.bridge``; a flax
gradient tree has the params' structure, so the same bridge maps the JAX
gradients onto the port's parameter names.

Tolerances: gradients atol = rtol = 1e-4 (f32 on both sides); training
losses 1e-4 relative at step 0 and 1e-3 relative after it (Adam's first
updates are ~lr * sign(grad), so rounding in a near-zero gradient moves a
weight by up to lr and the trajectories drift apart slowly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sputnik_tpu_torch as stt
from sputnik_tpu.models.attention import SparseAttention as JAttention
from sputnik_tpu.models.linear import SparseLinear as JLinear
from sputnik_tpu.topology import SparseTopology as JTopology
from sputnik_tpu_torch import bridge
from sputnik_tpu_torch.examples import train_sparse_transformer as example
from sputnik_tpu_torch.models import SparseAttention, SparseLinear

from test_torch_models import _entry_models, _randomise_biases

TOL = dict(atol=1e-4, rtol=1e-4)


def _check_grads(module, grads_sd, tol=TOL):
    params = dict(module.named_parameters())
    assert set(grads_sd) == set(params)
    for name, ref in grads_sd.items():
        got = params[name].grad
        assert got is not None, name
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **tol,
                                   err_msg=name)


@pytest.mark.parametrize("fuse_relu", [False, True])
def test_sparse_linear_gradients_match_flax(fuse_relu):
    rng = np.random.RandomState(0)
    mask = (rng.rand(48, 40) < 0.3).astype(np.float32)
    mask[5] = 0.0
    x = rng.randn(3, 5, 40).astype(np.float32)
    cot = rng.randn(3, 5, 48).astype(np.float32)
    jl = JLinear(topology=JTopology.from_dense_mask(mask), fuse_relu=fuse_relu)
    params = _randomise_biases(jl.init(jax.random.PRNGKey(0), x), 1)
    g_params, g_x = jax.grad(
        lambda p, x_: jnp.sum(jl.apply(p, x_) * cot), argnums=(0, 1))(
            params, x)

    tl = SparseLinear(stt.SparseTopology.from_dense_mask(mask),
                      fuse_relu=fuse_relu)
    tl.load_state_dict(bridge.sparse_linear_state_dict(params, tl))
    tx = torch.from_numpy(x).requires_grad_()
    (tl(tx) * torch.from_numpy(cot)).sum().backward()
    _check_grads(tl, bridge.sparse_linear_state_dict(g_params, tl))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g_x), **TOL)
    # the values' gradient is exactly 0 at masked and padded slots
    assert torch.all(tl.values.grad[~torch.from_numpy(tl.spec.view.mask)]
                     == 0)


def _attention_pair(seed, weight_masks=None):
    rng = np.random.RandomState(seed)
    s, e, heads = 40, 32, 2
    mask = (rng.rand(s, s) < 0.3).astype(np.float32)
    mask[11] = 0.0
    x = rng.randn(2, s, e).astype(np.float32)
    jw = tw = None
    if weight_masks is not None:
        jw = tuple(JTopology.from_dense_mask(m) for m in weight_masks)
        tw = tuple(stt.SparseTopology.from_dense_mask(m)
                   for m in weight_masks)
    ja = JAttention(num_heads=heads, embed_dim=e, weight_topologies=jw,
                    score_topology=JTopology.from_dense_mask(mask))
    params = _randomise_biases(ja.init(jax.random.PRNGKey(1), x), 2)
    ta = SparseAttention(heads, e, stt.SparseTopology.from_dense_mask(mask),
                         weight_topologies=tw)
    ta.load_state_dict(bridge.sparse_attention_state_dict(params, ta))
    return ja, params, ta, x, rng


def test_sparse_attention_gradients_match_flax():
    ja, params, ta, x, rng = _attention_pair(1)
    cot = rng.randn(*x.shape).astype(np.float32)
    g_params, g_x = jax.grad(
        lambda p, x_: jnp.sum(ja.apply(p, x_) * cot), argnums=(0, 1))(
            params, x)
    tx = torch.from_numpy(x).requires_grad_()
    (ta(tx) * torch.from_numpy(cot)).sum().backward()
    _check_grads(ta, bridge.sparse_attention_state_dict(g_params, ta))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g_x), **TOL)


@pytest.mark.parametrize("num_kv_heads", [None, 2])
@pytest.mark.parametrize("layout", ["flash", "xla"])
def test_transformer_gradients_match_flax(layout, num_kv_heads):
    """``__graft_entry__``'s config (b=2, s=128, h=128, 4 heads, 2 layers,
    ffn 256, causal masks with a fully-masked row)."""
    jm, params, tm, x = _entry_models(num_kv_heads, layout)
    cot = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    g_params, g_x = jax.jit(jax.grad(
        lambda p, x_: jnp.sum(jm.apply(p, x_) * cot), argnums=(0, 1)))(
            params, x)
    tx = torch.from_numpy(x).requires_grad_()
    (tm(tx) * torch.from_numpy(cot)).sum().backward()
    _check_grads(tm, bridge.transformer_state_dict(g_params))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g_x), **TOL)


def _optax_losses(apply, params, x, y, steps):
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step(p, s):
        loss, grads = jax.value_and_grad(
            lambda p_: jnp.mean((apply(p_, x) - y) ** 2))(p)
        updates, s = tx.update(grads, s)
        return optax.apply_updates(p, updates), s, loss

    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
    return losses, params


def _port_losses(model, x, y, steps):
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    return [float(example.train_step(model, opt, tx, ty))
            for _ in range(steps)]


def _check_losses(got, ref):
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4)
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-3)
    assert got[-1] < got[0]


def test_three_adam_steps_match_optax():
    """Three steps of the port's ``train_step`` (torch Adam) against three
    steps of the JAX example's loop (``optax.adam(1e-3)``, MSE) from the
    same bridged parameters, at ``__graft_entry__``'s config."""
    jm, params, tm, x = _entry_models()
    y = np.random.RandomState(6).randn(*x.shape).astype(np.float32)
    ref, _ = _optax_losses(jm.apply, params, x, y, 3)
    _check_losses(_port_losses(tm, x, y, 3), ref)


def test_sparse_attention_trains_like_optax_and_keeps_pruned_weights():
    """SparseAttention with sparse projections: three Adam steps match optax,
    and every masked slot of every SparseLinear values panel is still
    exactly 0 afterwards (its gradient is exactly 0 there)."""
    rng = np.random.RandomState(8)
    wm = [(rng.rand(32, 32) < 0.4).astype(np.float32) for _ in range(4)]
    ja, params, ta, x, rng = _attention_pair(3, weight_masks=wm)
    y = rng.randn(*x.shape).astype(np.float32)
    ref, j_params = _optax_losses(ja.apply, params, x, y, 3)
    _check_losses(_port_losses(ta, x, y, 3), ref)
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        lin = getattr(ta, name)
        off = ~torch.from_numpy(lin.spec.view.mask)
        assert off.any()
        assert torch.all(lin.values.detach()[off] == 0), name
        np.testing.assert_allclose(
            lin.unpack_dense(lin.values),
            ja.bind(j_params).__getattr__(name).unpack_dense(
                j_params["params"][name]["values"]), atol=1e-5)


def test_example_runs_small_on_cpu():
    losses = example.main(["--small", "--device", "cpu", "--steps", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[1] < losses[0]


def test_example_refuses_a_missing_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(["--small", "--steps", "1"])
