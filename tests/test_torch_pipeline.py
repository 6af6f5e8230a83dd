"""The port's GPipe pipeline (``parallel.pipeline_apply``) against the JAX
package's on the CPU, the stage parameters carried across by
``bridge.stacked_stage_state_dict``.

JAX runs its ``pipeline_apply`` under ``shard_map`` on the conftest's
virtual 8-device CPU mesh (its first 2 or 4 devices); the port on a
one-device ``Mesh``, every stage in this process. The stages are JAX's
``tests/test_pipeline.py`` layers (mb=2, s=16, h=32, 2 heads, ffn 48,
residual, LayerNorm, gelu, causal masks, the panel layout), two
microbatches. Tolerances: output 1e-4, gradients of every stacked
parameter and of the input 1e-3 (the port's MoE tolerances). Then the
flash layout: the pipeline against the port's own sequential stack, and
the schedule's arithmetic; the spec's errors; ``dryrun_pp`` /
``dryrun_ep`` at 2 and 4 positions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from torch.func import functional_call

from sputnik_tpu.many_mask import ManyMaskTopology as JMMT
from sputnik_tpu.models.transformer import TransformerLayer as JLayer
from sputnik_tpu.parallel import pipeline as jpipe
import sputnik_tpu_torch as stt
from sputnik_tpu_torch import bridge
from sputnik_tpu_torch.models import TransformerLayer
from sputnik_tpu_torch.parallel import (Mesh, PipelineSpec, pipeline_apply,
                                        stack_stage_params)

FWD = dict(atol=1e-4, rtol=1e-4)
GRAD = dict(atol=1e-3, rtol=1e-3)
MB, S, H, HEADS, FFN, N_MICRO = 2, 16, 32, 2, 48, 2
CFG = dict(use_residual=True, use_layernorm=True, activation="gelu")


def _masks():
    return np.broadcast_to(np.tril(np.ones((S, S), np.float32)),
                           (MB, S, S)).copy()


def _port_layer(layout, seed=0):
    return TransformerLayer(
        stt.ManyMaskTopology.from_dense_masks(_masks()), H, HEADS, FFN,
        attention_layout=layout,
        generator=torch.Generator().manual_seed(seed), **CFG)


@pytest.mark.parametrize("ndev", [2, 4])
def test_pipeline_matches_jax(ndev):
    """Forward and the gradients of every stacked parameter and of x."""
    layer = JLayer(mask_topology=JMMT.from_dense_masks(_masks()),
                   hidden_size=H, num_heads=HEADS, ffn_hidden_size=FFN,
                   attention_layout="panel", **CFG)
    rng = np.random.RandomState(0)
    x0 = jnp.asarray(rng.randn(MB, S, H).astype(np.float32) * 0.3)
    stacked = jpipe.stack_stage_params([
        layer.init(jax.random.PRNGKey(i), x0)["params"]
        for i in range(ndev)])
    x = rng.randn(N_MICRO * MB, S, H).astype(np.float32) * 0.3
    spec = jpipe.PipelineSpec(JMesh(np.array(jax.devices()[:ndev]), ("pp",)),
                              "pp", n_micro=N_MICRO)

    def loss(p, xx):
        out = jpipe.pipeline_apply(
            spec, lambda q, xm: layer.apply({"params": q}, xm), p, xx)
        return jnp.mean(out ** 2), out

    (_, ref), (g_p, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(stacked, jnp.asarray(x))

    tl = _port_layer("panel")
    st = {k: v.requires_grad_() for k, v in
          bridge.stacked_stage_state_dict(stacked, tl).items()}
    assert all(v.shape[0] == ndev for v in st.values())
    tx = torch.from_numpy(x).requires_grad_()
    out = pipeline_apply(PipelineSpec(Mesh({"pp": ndev}), n_micro=N_MICRO),
                         lambda q, xm: functional_call(tl, q, (xm,)), st, tx)
    (out ** 2).mean().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g_x), **GRAD)
    for name, want in bridge.stacked_stage_state_dict(g_p, tl).items():
        np.testing.assert_allclose(st[name].grad.numpy(), want.numpy(),
                                   **GRAD, err_msg=name)
    # a rank's slice of the same carry: stage 1 alone
    one = bridge.stacked_stage_state_dict(stacked, tl, position=1)
    for name, v in one.items():
        assert torch.equal(v, st[name].detach()[1:2]), name


def test_pipeline_flash_layout_matches_the_sequential_stack():
    """Three flash-layout stages, three microbatches: output and gradients
    equal to each microbatch through the stages one after another (the
    unsharded model's work), and the stage calls T * ndev."""
    ndev, n_micro = 3, 3
    layers = [_port_layer("flash", seed=i) for i in range(ndev)]
    stacked = stack_stage_params([dict(l.named_parameters()) for l in layers])
    pipe = {k: v.detach().clone().requires_grad_() for k, v in
            stacked.items()}
    seq = {k: v.detach().clone().requires_grad_() for k, v in
           stacked.items()}
    calls = []

    def stage(p, xm):
        calls.append(xm.shape[0])
        return functional_call(layers[0], p, (xm,))

    x = torch.from_numpy(np.random.RandomState(1).randn(
        n_micro * MB, S, H).astype(np.float32) * 0.3)
    out = pipeline_apply(PipelineSpec(Mesh({"pp": ndev}), n_micro=n_micro),
                         stage, pipe, x)
    assert calls == [MB] * (n_micro + ndev - 1) * ndev
    outs = []
    for j in range(n_micro):
        y = x[j * MB:(j + 1) * MB]
        for i in range(ndev):
            y = stage({k: v[i] for k, v in seq.items()}, y)
        outs.append(y)
    ref = torch.cat(outs)
    (out ** 2).mean().backward()
    (ref ** 2).mean().backward()
    torch.testing.assert_close(out, ref, **FWD)
    for name in pipe:
        torch.testing.assert_close(pipe[name].grad, seq[name].grad, **GRAD)
        assert pipe[name].grad.abs().max() > 0, name


def test_pipeline_validation():
    mesh = Mesh({"pp": 2})
    st = {"w": torch.ones(2, 3)}
    with pytest.raises(ValueError, match="parallel.Mesh"):
        PipelineSpec(object())
    with pytest.raises(ValueError, match="no axis"):
        PipelineSpec(mesh, "ep")
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_apply(PipelineSpec(mesh, n_micro=2), lambda p, x: x, st,
                       torch.ones(3, 3))
    with pytest.raises(ValueError, match="leading axis of 2"):
        pipeline_apply(PipelineSpec(mesh), lambda p, x: x,
                       {"w": torch.ones(3, 3)}, torch.ones(2, 3))
    with pytest.raises(ValueError, match="no stages"):
        stack_stage_params([])


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_pp_and_ep_match_unsharded(n):
    """``dryrun_pp`` / ``dryrun_ep`` (the twins of JAX's ``_dryrun_pp`` /
    ``_dryrun_ep``) on the CPU's one-device mesh: each gradient within 1e-4
    of the unsharded sequential stack / module (they raise otherwise)."""
    from sputnik_tpu_torch.dryrun import dryrun_ep, dryrun_pp

    for got in (dryrun_pp(n, "cpu"), dryrun_ep(n, "cpu")):
        assert np.isfinite(got["loss"]) and got["max_diff"] <= 1e-4
