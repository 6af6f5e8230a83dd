"""The port's ``SparseMoE`` and the MoE sparse transformer against the JAX
package's flax modules on the CPU, with the flax weights carried across by
``sputnik_tpu_torch.bridge``.

The port runs its kernels' plain versions (the expert bank is
``spmm_bh``: B6 forward, B7 + B8 backward on the card); JAX runs its
default CPU path. Routing is compared first and must be EQUAL: a near-tie
between two experts' probabilities could route a token differently and
move its output by O(1), so the smallest top-choice margin is reported
beside a mismatch. Tolerances: outputs 1e-4, aux loss 1e-5, gradients
1e-3; losses of the Adam steps 1e-4 (step 0) and 1e-3 relative after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sputnik_tpu as st
from sputnik_tpu.models.moe import SparseMoE as JMoE
from sputnik_tpu.models.transformer import SparseTransformer as JTransformer
import sputnik_tpu_torch as stt
from sputnik_tpu_torch import bridge
from sputnik_tpu_torch.examples import train_moe_transformer as example
from sputnik_tpu_torch.models import SparseDecoder, SparseMoE

FWD = dict(atol=1e-4, rtol=1e-4)
GRAD = dict(atol=1e-3, rtol=1e-3)


def _masks(rng, h=32, f=48, density=0.4):
    return ((rng.rand(f, h) < density).astype(np.float32),
            (rng.rand(h, f) < density).astype(np.float32))


def _jax_routing(params, x, top_k):
    """JAX's expert choices ``[T, top_k]`` and the smallest margin between
    a chosen probability and the next one, from the flax router."""
    p = params["params"] if "params" in params else params
    xf = jnp.asarray(x, jnp.float32).reshape(-1, x.shape[-1])
    probs = np.asarray(jax.nn.softmax(xf @ p["router"]["kernel"], axis=-1))
    order = np.argsort(-probs, axis=-1, kind="stable")
    srt = np.take_along_axis(probs, order, axis=-1)
    margin = float((srt[:, :top_k] - srt[:, 1: top_k + 1]).min())
    return order[:, :top_k], margin


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_matches_flax(top_k, capacity_factor):
    """Forward, aux loss and the gradients of input, router and expert
    values; ``capacity_factor=0.5`` overflows the experts (tokens shed)."""
    rng = np.random.RandomState(top_k)
    m_in, m_out = _masks(rng)
    E = 4
    x = rng.randn(2, 8, 32).astype(np.float32)
    cot = rng.randn(2, 8, 32).astype(np.float32)
    jm = JMoE(topo_in=st.SparseTopology.from_dense_mask(m_in),
              topo_out=st.SparseTopology.from_dense_mask(m_out),
              num_experts=E, top_k=top_k, capacity_factor=capacity_factor)
    params = jm.init(jax.random.PRNGKey(0), x)

    def f(p, xx):
        y, mods = jm.apply(p, xx, mutable=["intermediates"])
        aux = mods["intermediates"]["aux_loss"][0]
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (ref, ref_aux)), (g_p, g_x) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    tm = SparseMoE(stt.SparseTopology.from_dense_mask(m_in),
                   stt.SparseTopology.from_dense_mask(m_out), E, top_k=top_k,
                   capacity_factor=capacity_factor, bank_tiles=(16, 32))
    tm.load_state_dict(bridge.moe_state_dict(params, tm))
    tx = torch.from_numpy(x).requires_grad_()
    y = tm(tx)
    (torch.sum(y * torch.from_numpy(cot)) + tm.aux_loss).backward()

    experts, margin = _jax_routing(params, x, top_k)
    np.testing.assert_array_equal(
        tm.last_experts.numpy(), experts,
        err_msg=f"routing differs; smallest top-choice margin {margin:.3e}")
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(float(tm.aux_loss.detach()), float(ref_aux),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g_x), **GRAD)
    params_t = dict(tm.named_parameters())
    for name, ref_g in bridge.moe_state_dict(g_p, tm).items():
        np.testing.assert_allclose(params_t[name].grad.numpy(), ref_g.numpy(),
                                   **GRAD, err_msg=name)
    if capacity_factor < 1 and top_k == 1:
        # C = 2 per expert for 16 tokens: some tokens got no expert at all
        assert (y.detach().abs().sum(-1) == 0).any()


@pytest.mark.parametrize("ep", [2, 8])
@pytest.mark.parametrize("top_k", [1, 2])
def test_expert_parallel_moe_matches_flax(top_k, ep):
    """``SparseMoE(mesh=Mesh({"ep": n}))`` on the one-device mesh against
    JAX's ``SparseMoE(mesh=Mesh(devs[:n], ("ep",)))`` (8 experts, the
    conftest's virtual CPU devices): forward and the gradients of input,
    router and expert values (a rank's bridge slice: the gloo worlds of
    ``test_torch_mesh_dist``)."""
    from jax.sharding import Mesh as JMesh

    rng = np.random.RandomState(10 + top_k)
    m_in, m_out = _masks(rng)
    E = 8
    x = rng.randn(2, 16, 32).astype(np.float32)
    kw = dict(num_experts=E, top_k=top_k)
    topos = dict(topo_in=st.SparseTopology.from_dense_mask(m_in),
                 topo_out=st.SparseTopology.from_dense_mask(m_out))
    # the parameters are the unsharded module's (JAX's test does the same)
    params = JMoE(**topos, **kw).init(jax.random.PRNGKey(0), x)
    jm = JMoE(**topos, mesh=JMesh(np.array(jax.devices()[:ep]), ("ep",)),
              axis="ep", **kw)

    def loss(p, xx):
        out = jm.apply(p, xx)
        return jnp.mean(out ** 2), out

    (_, ref), (g_p, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    tm = SparseMoE(stt.SparseTopology.from_dense_mask(m_in),
                   stt.SparseTopology.from_dense_mask(m_out),
                   mesh=stt.parallel.Mesh({"ep": ep}), bank_tiles=(16, 32),
                   **kw)
    assert tm.n_local == E // ep and tm.experts == range(E)
    tm.load_state_dict(bridge.moe_state_dict(params, tm))
    tx = torch.from_numpy(x).requires_grad_()
    y = tm(tx)
    (y ** 2).mean().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g_x), **GRAD)
    got = dict(tm.named_parameters())
    for name, ref_g in bridge.moe_state_dict(g_p, tm).items():
        np.testing.assert_allclose(got[name].grad.numpy(), ref_g.numpy(),
                                   **GRAD, err_msg=name)


def test_moe_expert_values_keep_their_pattern():
    """The expert values' gradient is exactly 0 off the topology, so Adam
    never moves a pruned weight."""
    rng = np.random.RandomState(7)
    m_in, m_out = _masks(rng)
    tm = SparseMoE(stt.SparseTopology.from_dense_mask(m_in),
                   stt.SparseTopology.from_dense_mask(m_out), 4, top_k=2,
                   generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    for _ in range(2):
        opt.zero_grad()
        (tm(torch.randn(16, 32)) ** 2).mean().backward()
        opt.step()
    for spec, vals in ((tm.spec_in, tm.w_in_values),
                       (tm.spec_out, tm.w_out_values)):
        off = ~spec.mask_bh("cpu")[0, 0]
        assert off.any() and torch.all(vals.detach()[:, off] == 0)


def _moe_models(layout="flash"):
    """The JAX test's interleaved config: b=2, s=16, h=32, ffn 48, 4
    layers, 2 heads, 4 experts top-2, MoE every 2nd layer."""
    rng = np.random.RandomState(0)
    b, s, h, f = 2, 16, 32, 48
    masks = np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                            (b, s, s)).copy()
    m_in, m_out = _masks(rng)
    cfg = dict(num_layers=4, hidden_size=h, num_heads=2, ffn_hidden_size=f,
               use_residual=True, use_layernorm=True, activation="gelu",
               moe_every=2, attention_layout=layout)
    jm = JTransformer.from_masks(
        masks, moe=JMoE(topo_in=st.SparseTopology.from_dense_mask(m_in),
                        topo_out=st.SparseTopology.from_dense_mask(m_out),
                        num_experts=4, top_k=2), **cfg)
    x = rng.randn(b, s, h).astype(np.float32)
    y = rng.randn(b, s, h).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), x)
    tm = stt.SparseTransformer.from_masks(
        masks, moe=dict(topo_in=stt.SparseTopology.from_dense_mask(m_in),
                        topo_out=stt.SparseTopology.from_dense_mask(m_out),
                        num_experts=4, top_k=2), **cfg)
    tm.load_state_dict(bridge.transformer_state_dict(params, tm))
    return jm, params, tm, x, y


def test_moe_transformer_forward_and_two_adam_steps_match_optax():
    """The example's objective (MSE + 0.01 x the summed router aux losses)
    through the port's ``train_step`` (torch Adam) against optax ``adam``
    from the same bridged parameters."""
    jm, params, tm, x, y = _moe_models()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(params, x)),
                               **FWD)

    tx_ = optax.adam(1e-3)
    opt_state = tx_.init(params)

    def loss_fn(p):
        out, mods = jm.apply(p, x, mutable=["intermediates"])
        aux = sum(jnp.sum(v) for v in jax.tree.leaves(mods["intermediates"]))
        mse = jnp.mean((out - y) ** 2)
        return mse + 0.01 * aux, (mse, aux)

    @jax.jit
    def step(p, s):
        (_, (mse, aux)), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        u, s = tx_.update(g, s)
        return optax.apply_updates(p, u), s, mse, aux

    ref = []
    p = params
    for _ in range(2):
        p, opt_state, mse, aux = step(p, opt_state)
        ref.append((float(mse), float(aux)))

    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = [tuple(float(v) for v in example.train_step(tm, opt, xt, yt))
           for _ in range(2)]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-3)
    assert got[1][0] < got[0][0]


def test_moe_layers_own_their_parameters_and_bad_configs_raise():
    _, params, tm, _, _ = _moe_models()
    moes = example.moe_layers(tm)
    assert sorted(moes) == [1, 3]
    assert all(hasattr(tm.layers[i].mlp, "to_4h") for i in (0, 2))
    a, b = moes[1], moes[3]
    for name in ("router.weight", "w_in_values", "w_out_values"):
        pa, pb = a.get_parameter(name), b.get_parameter(name)
        assert pa is not pb and pa.data_ptr() != pb.data_ptr()
        assert not torch.equal(pa, pb)
    mt = stt.ManyMaskTopology.from_dense_masks(np.ones((1, 8, 8)))
    with pytest.raises(ValueError, match="no moe module"):
        stt.SparseTransformer(mt, 2, 16, 2, 32, moe_every=2)
    topo = stt.SparseTopology.from_dense_mask(np.ones((8, 4)))
    with pytest.raises(ValueError, match="parallel.Mesh"):
        SparseMoE(topo, stt.SparseTopology.from_dense_mask(np.ones((4, 8))),
                  2, mesh=object())
    with pytest.raises(ValueError, match="transformer_state_dict|model"):
        bridge.transformer_state_dict(params)


def test_serving_decoder_rejects_a_moe_model():
    _, _, tm, _, _ = _moe_models()
    with pytest.raises(ValueError, match="training-side"):
        SparseDecoder(tm, s_max=32, bk=8)


def test_moe_example_runs_small_on_cpu():
    losses = example.main(["--small", "--device", "cpu", "--steps", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[1] < losses[0]


def test_moe_example_refuses_a_missing_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(["--small", "--steps", "1"])
